"""Sharded (ZeRO) checkpoints of the port (bigdl_tpu_torch/
serialization/checkpoint.py `save_sharded`, and DistriOptimizer's
`set_checkpoint(sharded=True)`), after tests/test_zero2.py's sharded
format cases and tests/test_checkpoint_cross_layout.py.

In this process: the format cases — shards concatenate on load, a torn
save never becomes a candidate, a crash while re-saving keeps the
previous checkpoint, a damaged shard or manifest falls back, an async
writer error surfaces at `wait()` — and the format both ways: a
sharded checkpoint the JAX package's `Checkpoint.save_sharded` wrote
loads in the port, and one the port wrote loads in the JAX package.

On two gloo ranks (spawned once; this module imports JAX only inside
its tests) and one: a ZeRO-2 DistriOptimizer run checkpointed sharded
(async) and preempted resumes bit for bit as the uninterrupted run; a
world-2 sharded checkpoint loads as the same bits as the full-format
checkpoint of the same run, and resumed at world 1 trains the bits a
world-1 resume from the full format trains; the reverse from world 1 to
world 2 likewise. Everything here is compared exactly.
"""

import os
import shutil

import numpy as np
import pytest
import torch

N, BATCH, STEPS = 64, 16, 4


@pytest.fixture(autouse=True)
def _no_plan():
    from bigdl_tpu_torch.utils import faults

    faults.set_plan(None)
    try:
        yield
    finally:
        faults.set_plan(None)


# ------------------------------------------------------------- the format
def _toy_shards(nshards=4, shard_size=3):
    full = {"m": np.arange(nshards * shard_size, dtype=np.float32),
            "v": np.arange(nshards * shard_size, dtype=np.float32) * 2}
    shards = {i: {k: v[i * shard_size:(i + 1) * shard_size]
                  for k, v in full.items()} for i in range(nshards)}
    return full, shards


def _model_tree():
    return {"params": {"w": np.ones((2, 2), np.float32)}, "state": {}}


META = {"layout": "zero2_flat", "num_shards": 4, "total": 12, "padded": 12}


def _ck(path, **kw):
    from bigdl_tpu_torch.serialization.checkpoint import Checkpoint

    return Checkpoint(str(path), **kw)


def test_roundtrip_concatenates_shards(tmp_path):
    from bigdl_tpu_torch.serialization.checkpoint import shard_unit_name

    ck = _ck(tmp_path)
    full, shards = _toy_shards()
    ck.save_sharded(3, _model_tree(), shards, nshards=4,
                    train_state={"neval": 3}, optim_meta=META)
    d = tmp_path / "checkpoint-3"
    assert (d / "MANIFEST.json").exists()
    assert (d / (shard_unit_name(0, 4) + ".npz")).exists()
    assert shard_unit_name(3, 8) == "optim-shard003of008"
    _, optim, ts, meta = ck.load(with_optim_meta=True)
    np.testing.assert_array_equal(optim["m"].numpy(), full["m"])
    np.testing.assert_array_equal(optim["v"].numpy(), full["v"])
    assert ts["neval"] == 3
    assert meta["layout"] == "zero2_flat" and meta["padded"] == 12


def test_torn_dir_never_a_candidate(tmp_path):
    from bigdl_tpu_torch.utils import faults

    ck = _ck(tmp_path)
    _, shards = _toy_shards()
    ck.save_sharded(2, _model_tree(), shards, nshards=4, optim_meta=META)
    faults.set_plan(faults.FaultPlan("ckpt_async_torn@4"))
    with pytest.raises(faults.FaultInjected):
        ck.save_sharded(4, _model_tree(), shards, nshards=4,
                        optim_meta=META)
    torn = tmp_path / "checkpoint-4"
    assert not torn.is_dir(), "torn save must never publish"
    assert (tmp_path / "checkpoint-4.inprogress").is_dir()
    assert ck.latest().endswith("checkpoint-2")
    # recovery re-saves step 4 over the stale staging
    faults.set_plan(None)
    ck.save_sharded(4, _model_tree(), shards, nshards=4, optim_meta=META)
    assert ck.latest().endswith("checkpoint-4")
    assert not (tmp_path / "checkpoint-4.inprogress").is_dir()


def test_resave_crash_keeps_previous_same_step_checkpoint(tmp_path):
    from bigdl_tpu_torch.utils import faults

    ck = _ck(tmp_path)
    full, shards = _toy_shards()
    ck.save_sharded(4, _model_tree(), shards, nshards=4,
                    train_state={"neval": 4}, optim_meta=META)
    faults.set_plan(faults.FaultPlan("ckpt_async_torn@4"))
    with pytest.raises(faults.FaultInjected):
        ck.save_sharded(4, _model_tree(), shards, nshards=4,
                        optim_meta=META)
    faults.set_plan(None)
    _, optim, ts = ck.load()
    assert ck._last_loaded.endswith("checkpoint-4") and ts["neval"] == 4
    np.testing.assert_array_equal(optim["m"].numpy(), full["m"])


def test_damaged_shard_or_manifest_falls_back(tmp_path):
    import json

    from bigdl_tpu_torch.serialization.checkpoint import (
        CheckpointCorruptError, shard_unit_name)
    from bigdl_tpu_torch.utils import faults

    ck = _ck(tmp_path)
    _, shards = _toy_shards()
    for step in (2, 4, 6):
        ck.save_sharded(step, _model_tree(), shards, nshards=4,
                        optim_meta=META)
    # a manifest that parses but lost its fields
    (tmp_path / "checkpoint-6" / "MANIFEST.json").write_text(
        json.dumps({"step": 6}))
    faults.corrupt_file(str(tmp_path / "checkpoint-4"
                            / (shard_unit_name(2, 4) + ".npz")))
    ck.load()
    assert ck._last_loaded.endswith("checkpoint-2")
    assert [os.path.basename(d) for d in ck.corrupt_skipped] == [
        "checkpoint-6", "checkpoint-4"]
    faults.corrupt_file(str(tmp_path / "checkpoint-2"
                            / (shard_unit_name(1, 4) + ".npz")))
    with pytest.raises(CheckpointCorruptError):
        _ck(tmp_path).load()


def test_async_error_surfaces_at_wait(tmp_path):
    from bigdl_tpu_torch.utils import faults

    ck = _ck(tmp_path, async_save=True)
    _, shards = _toy_shards()
    faults.set_plan(faults.FaultPlan("ckpt_async_torn@4"))
    ck.save_sharded(4, _model_tree(), shards, nshards=4,
                    optim_meta=META)  # returns at once
    with pytest.raises(faults.FaultInjected):
        ck.wait()
    # the error is consumed once; the saver is reusable after
    ck.save_sharded(6, _model_tree(), shards, nshards=4, optim_meta=META)
    ck.wait()
    assert ck.latest().endswith("checkpoint-6")


def test_format_both_ways_with_jax(tmp_path):
    from bigdl_tpu.serialization.checkpoint import Checkpoint as JCheckpoint

    full, shards = _toy_shards()
    JCheckpoint(str(tmp_path / "j")).save_sharded(
        5, _model_tree(), shards, nshards=4, train_state={"neval": 5},
        optim_meta=META)
    variables, optim, ts, meta = _ck(tmp_path / "j").load(
        with_optim_meta=True)
    np.testing.assert_array_equal(variables["params"]["w"].numpy(),
                                  np.ones((2, 2)))
    np.testing.assert_array_equal(optim["v"].numpy(), full["v"])
    assert ts["neval"] == 5 and meta == META

    tshards = {i: {k: torch.from_numpy(v) for k, v in s.items()}
               for i, s in shards.items()}
    _ck(tmp_path / "t").save_sharded(
        7, _model_tree(), tshards, nshards=4, train_state={"neval": 7},
        optim_meta=META)
    variables, optim, ts, meta = JCheckpoint(str(tmp_path / "t")).load(
        with_optim_meta=True)
    np.testing.assert_array_equal(np.asarray(optim["m"]), full["m"])
    assert ts["neval"] == 7 and meta == META


# ------------------------------------------------ ZeRO-2 across ranks
def _data():
    rng = np.random.RandomState(1)
    return (rng.rand(N, 6).astype(np.float32),
            rng.randint(0, 4, N).astype(np.int32))


def _run(mesh, ck_dir, steps, sharded=True, resume=False, plan=None):
    """A ZeRO-2 DistriOptimizer run of the MLP (SGD with momentum, the
    exact gradient wire), checkpointing every 2 steps; returns the flat
    final params, or None when the fault plan preempted it. A resumed
    run starts from another seed's weights and returns (params, the
    checkpoint it resumed from)."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from bigdl_tpu_torch.utils import faults

    xs, ys = _data()
    m = nn.Sequential(nn.Linear(6, 16), nn.ReLU(), nn.Linear(16, 4),
                      nn.LogSoftMax())
    m.variables = m.init(torch.Generator().manual_seed(6 if resume else 5),
                         device="cpu")
    opt = (optim.Optimizer(m, DataSet.array(
        [Sample(x, int(y)) for x, y in zip(xs, ys)], seed=7),
        nn.ClassNLLCriterion(), batch_size=BATCH, seed=3)
        .set_optim_method(optim.SGD(learningrate=0.5, momentum=0.9,
                                    dampening=0.0))
        .set_end_when(optim.Trigger.max_iteration(steps))
        .set_checkpoint(ck_dir, optim.Trigger.several_iteration(2),
                        sharded=sharded, async_save=sharded))
    if resume:
        opt.resume_from_checkpoint()
    faults.set_plan(None if plan is None else faults.FaultPlan(plan))
    try:
        out = DistriOptimizer(opt, mesh, grad_dtype=None, zero=2).run()
    except faults.Preempted:
        opt.checkpoint.wait()
        return None
    finally:
        faults.set_plan(None)
    flat = np.concatenate([t.detach().numpy().reshape(-1) for t in
                           _leaves(out.variables["params"])])
    return (flat, os.path.basename(opt.checkpoint._last_loaded)) \
        if resume else flat


def _leaves(tree):
    from bigdl_tpu_torch.models.convert import tree_leaves

    return tree_leaves(tree)


def _only_step(src, dst, step=2):
    """A checkpoint dir holding only `src`'s checkpoint-`step`."""
    os.makedirs(dst, exist_ok=True)
    shutil.copytree(os.path.join(src, f"checkpoint-{step}"),
                    os.path.join(dst, f"checkpoint-{step}"))
    return dst


def _scenarios(rank, world, base):
    from bigdl_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"data": world}, device="cpu")
    out = {"U": _run(mesh, f"{base}/U", STEPS),
           "F": _run(mesh, f"{base}/F", STEPS, sharded=False)}
    assert _run(mesh, f"{base}/R", STEPS, plan="preempt@3") is None
    out["R"] = _run(mesh, f"{base}/R", STEPS, resume=True)
    # world 1's checkpoints resumed here at world 2
    out["X2"] = _run(mesh, f"{base}/U1_2", STEPS, resume=True)
    out["Y2"] = _run(mesh, f"{base}/F1_2", STEPS, resume=True)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.distributed as dist

    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.parallel.launch import spawn

    base = str(tmp_path_factory.mktemp("zero2"))
    out = {}

    def world1(fn):
        mesh = make_mesh({"data": 1}, device="cpu")
        try:
            return fn(mesh)
        finally:
            mesh.close()
            assert not dist.is_initialized()

    # world 1 writes the checkpoints world 2 resumes from, and back
    world1(lambda m: (_run(m, f"{base}/U1", 2), _run(
        m, f"{base}/F1", 2, sharded=False)))
    _only_step(f"{base}/U1", f"{base}/U1_2")
    _only_step(f"{base}/F1", f"{base}/F1_2")
    out["w2"] = spawn(_scenarios, 2, f"{base}/spawn", base)
    out["X1"] = world1(lambda m: _run(m, _only_step(
        f"{base}/U", f"{base}/U_1"), STEPS, resume=True))
    out["Y1"] = world1(lambda m: _run(m, _only_step(
        f"{base}/F", f"{base}/F_1"), STEPS, resume=True))
    out["base"] = base
    return out


def test_zero2_sharded_preempt_resume_is_bitwise(runs):
    for r in runs["w2"]:
        assert r["R"][1] == "checkpoint-2"
        np.testing.assert_array_equal(r["R"][0], r["U"])
        # the checkpoint format does not touch the arithmetic
        np.testing.assert_array_equal(r["F"], r["U"])


def test_sharded_checkpoint_loads_as_the_full_format(runs):
    from bigdl_tpu_torch.serialization.checkpoint import shard_unit_name

    base = runs["base"]
    d = os.path.join(base, "U", "checkpoint-2")
    assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) == [
        "model.npz", shard_unit_name(0, 2) + ".npz",
        shard_unit_name(1, 2) + ".npz"]
    sv, ss, sts, smeta = _ck(os.path.join(base, "U")).load(
        d, with_optim_meta=True)
    fv, fs, fts, fmeta = _ck(os.path.join(base, "F")).load(
        os.path.join(base, "F", "checkpoint-2"), with_optim_meta=True)
    assert sts == fts and smeta == fmeta
    assert smeta["layout"] == "zero2_flat" and smeta["num_shards"] == 2
    for a, b in zip(_leaves(sv), _leaves(fv)):
        assert torch.equal(a, b)
    assert set(ss) == set(fs) and ss
    for k in fs:
        assert torch.equal(ss[k], fs[k])


def test_resume_across_world_sizes_is_bitwise(runs):
    # world 2 → world 1: the sharded resume trains the full-format bits
    for run in ("X1", "Y1"):
        assert runs[run][1] == "checkpoint-2"
    np.testing.assert_array_equal(runs["X1"][0], runs["Y1"][0])
    # world 1 → world 2, on every rank
    for r in runs["w2"]:
        assert r["X2"][1] == r["Y2"][1] == "checkpoint-2"
        np.testing.assert_array_equal(r["X2"][0], r["Y2"][0])
    assert runs["X1"][0].shape == runs["w2"][0]["U"].shape
