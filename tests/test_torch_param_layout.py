"""The flat parameter layout (bigdl_tpu_torch/parallel/param_layout.py)
against the JAX package's (bigdl_tpu/parallel/param_layout.py).

`FlatParamSpec.flatten` of a port params tree equals JAX's flatten of
the same tree bit for bit — the same leaf order (jax.tree_util's, dict
keys sorted), sizes and padding — on LeNet-5, ResNet-20 and a 2-layer
TransformerLM tree, at world sizes 1-4; unflatten inverts it; the ZeRO
slices cover the vector; `repad_flat` and `adapt_flat_tree` carry a
flat vector of one world size's layout into another's (and a
LocalOptimizer checkpoint's param-shaped slots into the flat layout),
as the JAX package's do, bit for bit. Everything is bitwise: flattening
moves values and never computes.
"""

import jax
import numpy as np
import pytest
import torch

import test_torch_cnn_models as cm
from bigdl_tpu.parallel import param_layout as jpl
from bigdl_tpu_torch.models.convert import (params_from_jax, tree_leaves,
                                            tree_leaves_with_path)
from bigdl_tpu_torch.parallel import param_layout as tpl


def _jax_model(name):
    if name == "lenet5":
        from bigdl_tpu.models import lenet

        return lenet.build(10)
    if name == "resnet20":
        from bigdl_tpu.models import resnet

        return resnet.build_cifar(20, 10)
    from bigdl_tpu.models.transformer import TransformerConfig, TransformerLM

    return TransformerLM(TransformerConfig(vocab_size=61, dim=32,
                                           num_heads=2, num_layers=2,
                                           max_len=32))


@pytest.fixture(scope="module", params=["lenet5", "resnet20",
                                        "transformer2"])
def trees(request):
    jv = cm._seeded(_jax_model(request.param), 3)
    return jv["params"], params_from_jax(jv["params"], device="cpu")


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_flatten_equals_jax_bitwise(trees, world):
    jp, tp = trees
    jspec, tspec = jpl.FlatParamSpec(jp, world), tpl.FlatParamSpec(tp, world)
    assert (tspec.total, tspec.padded, tspec.shard_size) == \
        (jspec.total, jspec.padded, jspec.shard_size)
    jflat = np.asarray(jspec.flatten(jp))
    tflat = tspec.flatten(tp)
    assert tflat.dtype == torch.float32
    np.testing.assert_array_equal(tflat.numpy(), jflat)
    # unflatten inverts flatten, leaf for leaf and path for path
    back = tspec.unflatten(tflat)
    for (pa, a), (pb, b) in zip(tree_leaves_with_path(back),
                                tree_leaves_with_path(tp)):
        assert pa == pb
        assert torch.equal(a, b)
    # the ZeRO slices are disjoint and cover the padded vector
    parts = [tspec.shard_slice(tflat, i) for i in range(world)]
    assert all(p.shape == (tspec.shard_size,) for p in parts)
    assert torch.equal(torch.cat(parts), tflat)
    for i in range(world):
        np.testing.assert_array_equal(
            parts[i].numpy(), np.asarray(jspec.shard_slice(
                jspec.flatten(jp), i)))


@pytest.mark.parametrize("src, dst", [(1, 4), (4, 1), (2, 3), (3, 2),
                                      (4, 4)])
def test_repad_and_adapt_across_world_sizes(trees, src, dst):
    jp, tp = trees
    tsrc, tdst = tpl.FlatParamSpec(tp, src), tpl.FlatParamSpec(tp, dst)
    jdst = jpl.FlatParamSpec(jp, dst)
    rng = np.random.RandomState(src * 10 + dst)
    slot = rng.randn(tsrc.padded).astype(np.float32)
    slot[tsrc.total:] = 0.0                       # padding is zeros
    meta = {"layout": "zero1_flat", "num_shards": src,
            "total": tsrc.total, "padded": tsrc.padded}
    got = tpl.adapt_flat_tree({"velocity": slot}, meta, tdst)["velocity"]
    want = jpl.adapt_flat_tree({"velocity": slot}, meta, jdst)["velocity"]
    assert got.shape == (tdst.padded,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tpl.repad_flat(slot, tsrc.total, tdst.padded).numpy(),
        np.asarray(jpl.repad_flat(slot, tsrc.total, jdst.padded)))
    # back to the source layout: the original vector, bit for bit
    back = tpl.repad_flat(got, tsrc.total, tsrc.padded)
    np.testing.assert_array_equal(back.numpy(), slot)
    # a LocalOptimizer checkpoint's param-shaped slots flatten into it
    local = {"velocity": tp}
    flat = tpl.adapt_flat_tree(local, None, tdst)["velocity"]
    np.testing.assert_array_equal(
        flat.numpy(),
        np.asarray(jpl.adapt_flat_tree({"velocity": jp}, None,
                                       jdst)["velocity"]))


def test_concat_unstack_map_and_gather():
    jv = cm._seeded(_jax_model("transformer2"), 5)
    tp = params_from_jax(jv["params"], device="cpu")
    spec = tpl.FlatParamSpec(tp, 3)
    flat = spec.flatten(tp)
    parts = [{"m": spec.shard_slice(flat, i)} for i in range(3)]
    cat = tpl.concat_shard_trees(parts)
    jcat = jpl.concat_shard_trees([{"m": np.asarray(p["m"])}
                                   for p in parts])
    np.testing.assert_array_equal(cat["m"], jcat["m"])
    np.testing.assert_array_equal(cat["m"], flat.numpy())
    blocks = tpl.unstack_blocks(tp, 2)
    jblocks = jpl.unstack_blocks(jv["params"], 2)
    assert len(blocks) == len(jblocks) == 2
    for tb, jb in zip(blocks, jblocks):
        assert sorted(tb) == sorted(jb)
        for k in tb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    serving = {**tp, "blocks": blocks}
    doubled = tpl.map_block_leaves(serving, lambda k, v: v * 2)
    assert torch.equal(doubled["blocks"][1]["wq"], blocks[1]["wq"] * 2)
    with pytest.raises(ValueError, match="per-layer serving layout"):
        tpl.map_block_leaves(tp, lambda k, v: v)
    host = tpl.gather_tree(tp)
    for a, b in zip(tree_leaves(host), jax.tree_util.tree_leaves(
            jpl.gather_tree(jv["params"]))):
        np.testing.assert_array_equal(a, b)
