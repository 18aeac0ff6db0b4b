"""The training CLI (bigdl_tpu_torch/models/train.py) against the JAX
package's (bigdl_tpu/models/train.py) on the CPU.

Both CLIs resume from one initial checkpoint in the JAX package's format
(seeded weights, zero momentum, step 0) — the CLIs draw their own
initial weights from different generators — then train one epoch of
LeNet-5 on the same `synthetic_mnist` data and write their end-of-epoch
checkpoint in the same format: equal train states, params and momentum
within 1e-4 absolute. (ResNet-20 from BDLS record shards is
test_torch_train_cli_records.py.) The port's CLI also trains from
TFRecord shards, through `--mesh data=1` (DistriOptimizer over a
one-rank gloo group, which the CLI destroys after the run; its
checkpoint carries the zero1_flat layout and matches the local run
within 2e-3 — the bf16 gradient wire), and refuses `--moeExperts 2`
naming its queue.
"""

import contextlib
import os
import shutil
import unittest.mock as mock

import numpy as np
import pytest
import torch.distributed as dist

from bigdl_tpu_torch.models import train as ttrain
from bigdl_tpu_torch.models.convert import tree_leaves
from bigdl_tpu_torch.serialization.checkpoint import Checkpoint


def _initial_checkpoint(jmodel, seed, path):
    """Step 0 of both runs: seeded weights (and BN statistics), zero
    momentum, in the JAX package's checkpoint format."""
    import jax
    import jax.numpy as jnp
    import test_torch_cnn_models as cm
    from bigdl_tpu.serialization.checkpoint import Checkpoint as JCheckpoint

    v = jax.tree_util.tree_map(jnp.asarray, cm._seeded(jmodel, seed))
    velocity = jax.tree_util.tree_map(jnp.zeros_like, v["params"])
    JCheckpoint(path).save(0, v, {"velocity": velocity},
                           {"epoch": 1, "neval": 0, "nupdates": 0,
                            "records": 0})


def _run_both(argv, ck, masked_planes=False, pkgs=("jax", "torch"),
              tag=""):
    """The JAX CLI and the port's (or those of `pkgs`) on the CPU from
    copies of `ck`; returns the final checkpoints, loaded by the port."""
    from bigdl_tpu.dataset import native as jnative
    from bigdl_tpu.models import train as jtrain
    from bigdl_tpu_torch.dataset import native as tnative

    out = {}
    for pkg in pkgs:
        d = f"{ck}-{pkg}{tag}"
        shutil.copytree(ck, d)
        args = argv + ["--checkpoint", d, "--resume"]
        with contextlib.ExitStack() as stack:
            if masked_planes:
                for nat in (jnative, tnative):
                    stack.enter_context(mock.patch.object(
                        nat, "_load", return_value=None))
            if pkg == "jax":
                jtrain.main(args)
            else:
                ttrain.main(args, device="cpu")
        out[pkg] = Checkpoint(d).load(with_optim_meta=True)
    return out


def _assert_checkpoints_close(out, atol, slot_atol):
    (tv, ts, tts, _), (jv, js, jts, _) = out["torch"], out["jax"]
    assert tts == jts
    for a, b in zip(tree_leaves(tv), tree_leaves(jv)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol, rtol=0)
    assert set(ts) == set(js) == {"velocity"}
    for a, b in zip(tree_leaves(ts), tree_leaves(js)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=slot_atol,
                                   rtol=0)


def test_lenet_cli_matches_jax(tmp_path):
    from bigdl_tpu.models import lenet

    ck = str(tmp_path / "ck")
    _initial_checkpoint(lenet.build(10), 1, ck)
    out = _run_both(["--model", "lenet", "-b", "512", "--maxEpoch", "1"],
                    ck)
    assert out["torch"][2]["neval"] == 8            # 4096 / 512
    _assert_checkpoints_close(out, atol=1e-4, slot_atol=1e-4)


def _record_shards(tmp_path, n=64, seed=3):
    from bigdl_tpu_torch.dataset import write_shards

    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, 32, 32, 3), np.uint8)
    labels = rng.randint(0, 10, n).astype(np.int32)
    d = str(tmp_path / "shards")
    write_shards(images, labels, d, 2)
    return d, images, labels


def test_tfrecords_and_mesh_and_moe(tmp_path):
    from bigdl_tpu_torch.dataset import write_image_examples

    _, images, labels = _record_shards(tmp_path, n=32)
    os.makedirs(tmp_path / "tf")
    write_image_examples(str(tmp_path / "tf" / "part-0.tfrecord"),
                         images, labels)
    opt = ttrain.main(["--model", "resnet20-cifar", "--tfrecords",
                       str(tmp_path / "tf"), "-b", "16", "--maxEpoch", "1"],
                      device="cpu")
    assert opt.train_state["neval"] == 2
    assert np.isfinite(float(opt.train_state["loss"]))

    runs = {}
    for name, extra in (("local", []), ("mesh", ["--mesh", "data=1"])):
        d = str(tmp_path / f"ck-{name}")
        opt = ttrain.main(["--model", "lenet", "-b", "512", "--maxEpoch",
                           "1", "--checkpoint", d] + extra, device="cpu")
        assert not dist.is_initialized()   # the CLI closed its group
        runs[name] = (opt, Checkpoint(d).load(with_optim_meta=True))
    assert runs["mesh"][0].mesh.backend == "gloo"
    assert runs["mesh"][1][3]["layout"] == "zero1_flat"
    assert runs["local"][1][3] is None or \
        runs["local"][1][3].get("layout") is None
    for a, b in zip(tree_leaves(runs["mesh"][1][0]),
                    tree_leaves(runs["local"][1][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3, rtol=0)

    # --moeExperts trains the MoE FFN transformer (A.8 step 5 ported)
    opt = ttrain.main(["--model", "transformer", "--moeExperts", "2",
                       "--moeTopK", "2", "-b", "4", "--maxEpoch", "1"],
                      device="cpu")
    assert opt.model.cfg.moe_experts == 2 and opt.model.cfg.moe_top_k == 2
    assert np.isfinite(float(opt.train_state["loss"]))
    with pytest.raises(SystemExit):
        ttrain.main(["--model", "ncf", "--records", str(tmp_path)],
                    device="cpu")
