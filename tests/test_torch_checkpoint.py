"""The port's checkpoints (bigdl_tpu_torch/serialization/checkpoint.py)
against the JAX package's: one on-disk format, so a checkpoint written
by either package loads in the other, and the port keeps the JAX
package's integrity contract (tests/test_checkpoint_integrity.py's
cases, run on the port).

Tolerance: none. A checkpoint holds host copies of the arrays, so every
tree read back — by either package — equals the one written, bit for
bit, and both packages' manifests name the same keys with the same
crc32s."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.serialization import checkpoint as jck
from bigdl_tpu.utils.table import Table as JTable
from bigdl_tpu_torch.serialization import checkpoint as tck
from bigdl_tpu_torch.utils import faults
from bigdl_tpu_torch.utils.faults import corrupt_file
from bigdl_tpu_torch.utils.table import Table as TTable


def _params(seed):
    rng = np.random.RandomState(seed)
    return {"blocks": {"wq": rng.randn(2, 4, 4).astype(np.float32),
                       "bq": rng.randn(2, 4).astype(np.float32)},
            "embed": rng.randn(7, 4).astype(np.float32),
            "head": {"weight": rng.randn(4, 7).astype(np.float32)}}


def _tree(seed, table):
    """A model, Adam slots, a train state and a mid-cycle accumulator,
    as host numpy trees; `table` builds the model's Table node."""
    p = _params(seed)
    rng = np.random.RandomState(seed + 100)
    slots = {k: jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32), p)
        for k in ("m", "v")}
    model = {"params": p,
             "state": {"bn": table({1: np.arange(3, dtype=np.float32),
                                    2: np.ones((2,), np.float32),
                                    10: np.zeros((1,), np.int32)})}}
    accum = {"g_acc": jax.tree_util.tree_map(lambda a: a * 0.5, p),
             "micro_n": 3}
    state = {"epoch": 2, "neval": 9, "nupdates": 3, "records": 40}
    return model, slots, state, accum


def _to_torch(tree):
    """The tree with torch leaves; dicts keep their type (Table)."""
    if isinstance(tree, dict):
        return type(tree)((k, _to_torch(v)) for k, v in tree.items())
    return torch.from_numpy(tree)


def _assert_same(a, b):
    """Equal trees: the same keys, dict kinds (a Table is a Table in
    either package), dtypes, shapes and bits."""
    if isinstance(a, dict):
        assert isinstance(b, dict)
        assert type(a).__name__ == type(b).__name__
        assert sorted(a, key=str) == sorted(b, key=str)
        for k in a:
            _assert_same(a[k], b[k])
        return
    x = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    y = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert x.dtype == y.dtype and x.shape == y.shape
    np.testing.assert_array_equal(x, y)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# ------------------------------------------------------- cross-package

def test_port_writes_jax_reads(tmp_path):
    model, slots, state, accum = _tree(0, TTable)
    ck = tck.Checkpoint(str(tmp_path))
    ck.save(9, _to_torch(model), _to_torch(slots), state,
            accum_state={"g_acc": _to_torch(accum["g_acc"]),
                         "micro_n": 3})
    j = jck.Checkpoint(str(tmp_path))
    assert j.latest() == str(tmp_path / "checkpoint-9")
    jm, js, jstate = j.load()
    _assert_same(jm["params"], model["params"])
    _assert_same(js, slots)
    assert jstate == state
    bn = jm["state"]["bn"]
    assert isinstance(bn, JTable) and sorted(bn) == [1, 2, 10]
    _assert_same(jm["state"], model["state"])
    jacc = j.load_accum()
    assert int(jacc["micro_n"]) == 3
    _assert_same(jacc["g_acc"], accum["g_acc"])


def test_jax_writes_port_reads(tmp_path):
    model, slots, state, accum = _tree(1, JTable)
    j = jck.Checkpoint(str(tmp_path))
    j.save(9, model, slots, state, accum_state=accum)
    ck = tck.Checkpoint(str(tmp_path))
    tm, ts, tstate = ck.load()
    assert all(isinstance(t, torch.Tensor) for t in _leaves(tm))
    _assert_same(tm["params"], model["params"])
    _assert_same(ts, slots)
    assert tstate == state
    assert isinstance(tm["state"]["bn"], TTable)
    assert tm["state"]["bn"][10].dtype == torch.int32
    tacc = ck.load_accum()
    assert int(tacc["micro_n"]) == 3
    _assert_same(tacc["g_acc"], accum["g_acc"])


def test_same_bytes_on_disk(tmp_path):
    """The same tree saved by both packages: the same npz keys and
    arrays, and manifests equal but for the save time."""
    model, _, _, _ = _tree(2, JTable)
    jck.save_pytree(str(tmp_path / "j"), "model", model,
                    metadata={"train_state": {"neval": 1}})
    tmodel, _, _, _ = _tree(2, TTable)
    tck.save_pytree(str(tmp_path / "t"), "model", _to_torch(tmodel),
                    metadata={"train_state": {"neval": 1}})
    mj, mt = (json.loads((tmp_path / d / "model.json").read_text())
              for d in ("j", "t"))
    del mj["saved_at"], mt["saved_at"]
    assert mj == mt
    with np.load(tmp_path / "j" / "model.npz") as zj, \
            np.load(tmp_path / "t" / "model.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            np.testing.assert_array_equal(zj[k], zt[k])
            assert zj[k].dtype == zt[k].dtype


def test_bf16_leaf_refused_by_name(tmp_path):
    tree = {"params": {"w": torch.ones(2, dtype=torch.bfloat16)}}
    with pytest.raises(ValueError, match="params/w is bfloat16"):
        tck.Checkpoint(str(tmp_path)).save(1, tree, {})


def test_sharded_checkpoints_name_a8(tmp_path):
    with pytest.raises(NotImplementedError, match="A.8"):
        tck.Checkpoint(str(tmp_path), sharded=True)
    ck = tck.Checkpoint(str(tmp_path))
    with pytest.raises(NotImplementedError, match="A.8"):
        ck.save_sharded(1, {}, {}, 1)
    # a sharded directory written by the JAX package is a candidate, and
    # loading it names the queue rather than skipping it as corrupt
    d = tmp_path / "checkpoint-4"
    d.mkdir()
    (d / tck.Checkpoint.MANIFEST).write_text('{"nshards": 2}')
    with pytest.raises(NotImplementedError, match="A.8"):
        ck.load()


# ------------------------------------------------------------ integrity

def _vars(seed):
    rng = np.random.RandomState(seed)
    return {"params": {"w": torch.from_numpy(rng.rand(4, 3).astype(
        np.float32)), "b": torch.from_numpy(rng.rand(3).astype(
            np.float32))}, "state": {}}


def _save_steps(path, steps):
    ck = tck.Checkpoint(str(path))
    for s in steps:
        ck.save(s, _vars(s), {"m": torch.full((7,), float(s))},
                train_state={"neval": s})
    return ck


def _loaded_step(ck, **kw):
    _, _, ts = ck.load(**kw)
    return ts["neval"]


@pytest.mark.parametrize("unit, mode", [("model", "truncate"),
                                        ("optim", "garble")])
def test_damaged_npz_falls_back(tmp_path, unit, mode):
    ck = _save_steps(tmp_path, [3, 6])
    corrupt_file(str(tmp_path / "checkpoint-6" / f"{unit}.npz"), mode)
    assert _loaded_step(ck) == 3
    assert ck.corrupt_skipped == [str(tmp_path / "checkpoint-6")]
    assert ck._last_loaded == str(tmp_path / "checkpoint-3")


def test_missing_manifest_falls_back(tmp_path):
    ck = _save_steps(tmp_path, [3, 6])
    os.remove(tmp_path / "checkpoint-6" / "optim.json")
    assert ck.latest() == str(tmp_path / "checkpoint-6")
    assert _loaded_step(ck) == 3


def test_unparseable_manifest_falls_back(tmp_path):
    ck = _save_steps(tmp_path, [3, 6])
    (tmp_path / "checkpoint-6" / "model.json").write_text("{not json")
    assert _loaded_step(ck) == 3


def test_all_candidates_corrupt_raises(tmp_path):
    ck = _save_steps(tmp_path, [3])
    corrupt_file(str(tmp_path / "checkpoint-3" / "model.npz"), "truncate")
    with pytest.raises(tck.CheckpointCorruptError,
                       match="no valid checkpoint"):
        ck.load()


def test_no_checkpoint_raises_filenotfound(tmp_path):
    with pytest.raises(FileNotFoundError):
        tck.Checkpoint(str(tmp_path)).load()


def test_explicit_directory_damage_raises(tmp_path):
    ck = _save_steps(tmp_path, [3, 6])
    corrupt_file(str(tmp_path / "checkpoint-6" / "model.npz"), "garble")
    with pytest.raises(tck.CheckpointCorruptError):
        ck.load(directory=str(tmp_path / "checkpoint-6"))


def test_staging_and_torn_dirs_never_candidates(tmp_path):
    ck = _save_steps(tmp_path, [3])
    staging = tmp_path / "checkpoint-9.inprogress"
    tck.save_pytree(str(staging), "model", _vars(9), metadata={})
    tck.save_pytree(str(staging), "optim", {"m": torch.ones(7)})
    torn = tmp_path / "checkpoint-8"
    tck.save_pytree(str(torn), "model", _vars(8), metadata={})
    assert ck.latest() == str(tmp_path / "checkpoint-3")
    assert _loaded_step(ck) == 3


def test_latest_allow_unmarked(tmp_path):
    ck = _save_steps(tmp_path, [3])
    legacy = tmp_path / "checkpoint-8"
    tck.save_pytree(str(legacy), "model", _vars(8),
                    metadata={"train_state": {"neval": 8}})
    tck.save_pytree(str(legacy), "optim", {"m": torch.ones(7)})
    assert ck.latest() == str(legacy)
    assert ck.latest(allow_unmarked=False) == str(tmp_path / "checkpoint-3")
    assert _loaded_step(ck) == 8
    assert _loaded_step(ck, allow_unmarked=False) == 3


def test_verify_and_missing_array(tmp_path):
    tck.save_pytree(str(tmp_path), "unit", {"x": torch.arange(64.0),
                                            "y": torch.arange(4.0)})
    tck.verify_pytree(str(tmp_path), "unit")
    npz = tmp_path / "unit.npz"
    with np.load(npz) as z:
        kept = {k: z[k] for k in z.files if k != "y"}
    np.savez(npz, **kept)
    with pytest.raises(tck.CheckpointCorruptError, match="missing arrays"):
        tck.load_pytree(str(tmp_path), "unit")


def test_load_accum_follows_last_loaded(tmp_path):
    ck = tck.Checkpoint(str(tmp_path))
    for s, n in ((3, 1), (6, 2)):
        ck.save(s, _vars(s), {"m": torch.ones(7)},
                accum_state={"g_acc": torch.full((7,), float(s)),
                             "micro_n": n})
    corrupt_file(str(tmp_path / "checkpoint-6" / "model.npz"), "truncate")
    ck.load()
    acc = ck.load_accum()
    assert int(acc["micro_n"]) == 1
    assert torch.equal(acc["g_acc"], torch.full((7,), 3.0))
    corrupt_file(str(tmp_path / "checkpoint-3" / "accum.npz"), "garble")
    assert ck.load_accum() is None  # a warning, never a failed recovery


def test_resave_replaces_the_directory(tmp_path):
    ck = tck.Checkpoint(str(tmp_path))
    ck.save(4, _vars(4), {"m": torch.ones(7)},
            accum_state={"g_acc": torch.ones(7), "micro_n": 1})
    assert (tmp_path / "checkpoint-4" / "accum.json").exists()
    ck.save(4, _vars(5), {"m": torch.ones(7)})
    assert not (tmp_path / "checkpoint-4" / "accum.json").exists()
    assert not (tmp_path / "checkpoint-4.old").exists()
    model, _, _ = ck.load()
    assert torch.equal(model["params"]["w"], _vars(5)["params"]["w"])


# ----------------------------------------------------------------- async

def test_async_save_lands_and_snapshots_on_the_caller(tmp_path):
    ck = tck.Checkpoint(str(tmp_path), async_save=True)
    live = {"params": {"w": torch.zeros(3)}, "state": {}}
    ck.save(1, live, {})
    live["params"]["w"].add_(5.0)  # after save() returns: not in it
    ck.save(2, live, {})
    ck.wait()
    assert torch.equal(ck.load(str(tmp_path / "checkpoint-1"))[0][
        "params"]["w"], torch.zeros(3))
    assert torch.equal(ck.load()[0]["params"]["w"], torch.full((3,), 5.0))


def test_async_writer_error_raised_by_wait(tmp_path):
    faults.set_plan(faults.FaultPlan("ckpt_torn@2"))
    try:
        ck = tck.Checkpoint(str(tmp_path), async_save=True)
        ck.save(1, _vars(1), {})
        ck.save(2, _vars(2), {})  # the writer dies mid-save
        with pytest.raises(faults.FaultInjected, match="ckpt_torn@2"):
            ck.wait()
        ck.wait()  # the error is raised once
        assert (tmp_path / "checkpoint-2.inprogress").is_dir()
        assert ck.latest() == str(tmp_path / "checkpoint-1")
        ck.save(3, _vars(3), {})
        ck.wait()
        assert ck.latest() == str(tmp_path / "checkpoint-3")
    finally:
        faults.set_plan(None)


def test_ckpt_corrupt_fault_damages_the_published_model(tmp_path):
    faults.set_plan(faults.FaultPlan("ckpt_corrupt@6"))
    try:
        ck = _save_steps(tmp_path, [3, 6])
        assert ck.latest() == str(tmp_path / "checkpoint-6")
        assert _loaded_step(ck) == 3
        assert ck.corrupt_skipped == [str(tmp_path / "checkpoint-6")]
    finally:
        faults.set_plan(None)
