"""Pipeline parallelism of the port's Transformer-LM
(bigdl_tpu_torch/parallel/pipeline.py) on four gloo ranks, after
tests/test_pipeline.py and __graft_entry__.py's `_dryrun_pipeline`:
GPipe over a pipe axis of 2, GPipe over pipe 2 × data 2, and the
interleaved schedule over pipe 2 × 2 virtual stages, each step's loss
and parameters against the JAX package's step on the same mesh of the
CPU devices that tests/conftest.py forces and its loss against the
single-device loss; the schedule tables, bubble fractions and
`to_virtual_layout` against the JAX package's.

The ranks are spawned once on a {"pipe": 2, "data": 2} mesh (the pure
pipe cases train the whole batch on each data row); they return the
loss and the parameters after one step, gathered over the pipe axis
(this module imports JAX only inside its tests). Tolerances (fp32):
losses within 1e-5 absolute; parameters after a step within 1e-5
relative (1e-6 absolute floor).
"""

import numpy as np
import pytest
import torch

CFG = dict(vocab_size=64, max_len=16, dim=32, num_heads=4, num_layers=4)
MESH = {"pipe": 2, "data": 2}
LR = 0.1
TOL = 1e-5
# name: (dp_axis, virtual_stages, batch)
CASES = {"gpipe": (None, 1, 4), "gpipe_dp": ("data", 1, 8),
         "interleaved": (None, 2, 4)}


def _init():
    from bigdl_tpu_torch.models.convert import tree_map
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)

    m = TransformerLM(TransformerConfig(**CFG), device="cpu")
    return tree_map(lambda t: t.numpy(),
                    m.init_params(torch.Generator().manual_seed(0)))


def _batch(b):
    rng = np.random.RandomState(0)
    return (rng.randint(0, 64, (b, 16)).astype(np.int32),
            rng.randint(0, 64, (b, 16)).astype(np.int32))


def _scenarios(rank, world, init):
    from bigdl_tpu_torch.models.convert import tree_leaves, tree_map
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import (make_mesh,
                                          make_pipeline_train_step,
                                          shard_params, to_virtual_layout)
    from bigdl_tpu_torch.parallel.tensor_parallel import gather_params

    mesh = make_mesh(MESH, device="cpu")
    model = TransformerLM(TransformerConfig(**CFG), device="cpu")
    out = {}
    for name, (dp, v, b) in CASES.items():
        method = SGD(learningrate=LR)
        step = make_pipeline_train_step(model, method, mesh, "pipe", dp,
                                        microbatches=2, virtual_stages=v)
        tree = tree_map(torch.from_numpy, init)
        if v > 1:
            tree = to_virtual_layout(tree, 2, v)
        params = shard_params(mesh, step.specs, tree)
        slots = method.init_slots(tree_leaves(params))
        toks, tgts = (torch.from_numpy(a) for a in _batch(b))
        params, _, loss = step(params, slots, toks, tgts, LR, 0)
        out[name] = (float(loss), step.bubble_fraction, tree_map(
            lambda t: t.numpy(), gather_params(mesh, step.specs, params)))
    return out


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    from bigdl_tpu_torch.parallel.launch import spawn

    return spawn(_scenarios, 4, str(tmp_path_factory.mktemp("pipe")),
                 _init())


def _single_device_loss(b):
    from bigdl_tpu_torch.models.convert import tree_map
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)

    toks, tgts = (torch.from_numpy(a) for a in _batch(b))
    m = TransformerLM(TransformerConfig(**CFG), device="cpu")
    logp, _ = m.apply({"params": tree_map(torch.from_numpy, _init())}, toks)
    return float(-logp.gather(-1, tgts.long()[..., None]).mean())


def _jax_step(dp, v, b):
    import jax
    import jax.numpy as jnp

    from bigdl_tpu.models.transformer import (TransformerConfig as JCfg,
                                              TransformerLM as JLM)
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu.parallel import (make_mesh, make_pipeline_train_step,
                                    pipeline_specs, shard_params,
                                    slot_specs_for, to_virtual_layout)

    axes = {"pipe": 2, "data": 2} if dp else {"pipe": 2}
    mesh = make_mesh(axes, devices=jax.devices()[:4 if dp else 2])
    method = JSGD(learningrate=LR)
    specs = pipeline_specs("pipe")
    step = make_pipeline_train_step(JLM(JCfg(**CFG)), method, mesh, "pipe",
                                    dp, microbatches=2, virtual_stages=v)
    p = jax.tree_util.tree_map(jnp.asarray, _init())
    if v > 1:
        p = to_virtual_layout(p, 2, v)
    slots = shard_params(mesh, slot_specs_for(method, specs),
                         method.init_slots(p))
    args = (shard_params(mesh, specs, p), slots) + tuple(
        jnp.asarray(a) for a in _batch(b)) + (
        jnp.asarray(LR), jnp.asarray(0), jax.random.PRNGKey(1))
    # backend optimisation 0: half the compile time, the same HLO
    p, _, loss = step.lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)
    return float(loss), step.bubble_fraction, jax.device_get(p)


@pytest.mark.parametrize("name", sorted(CASES))
def test_step_matches_jax_and_one_device(w4, name):
    from bigdl_tpu_torch.models.convert import tree_leaves_with_path

    dp, v, b = CASES[name]
    jloss, jbubble, jparams = _jax_step(dp, v, b)
    ref = _single_device_loss(b)
    want = dict(tree_leaves_with_path(jparams))
    for res in w4:
        loss, bubble, params = res[name]
        np.testing.assert_allclose(loss, jloss, atol=TOL, rtol=0)
        np.testing.assert_allclose(loss, ref, atol=TOL, rtol=0)
        assert bubble == jbubble
        for path, got in tree_leaves_with_path(params):
            np.testing.assert_allclose(got, want[path], rtol=TOL,
                                       atol=1e-6, err_msg=str(path))


def test_bubble_fraction_smaller_interleaved(w4):
    from bigdl_tpu.parallel import pipeline as jpipe

    from bigdl_tpu_torch.parallel import pipeline as tpipe

    assert w4[0]["interleaved"][1] < w4[0]["gpipe"][1]
    for n, m, v in ((2, 2, 2), (4, 8, 2), (4, 8, 1), (3, 5, 3)):
        assert tpipe._injection_schedule(n, m, v) == \
            jpipe._injection_schedule(n, m, v)
        assert tpipe.interleaved_bubble_fraction(n, m, v) == \
            jpipe.interleaved_bubble_fraction(n, m, v)
        assert tpipe.pipeline_bubble_fraction(n, m) == \
            jpipe.pipeline_bubble_fraction(n, m)
    assert tpipe.interleaved_bubble_fraction(4, 8, 2) < \
        tpipe.pipeline_bubble_fraction(4, 8)


def test_virtual_layout_round_trip_and_refusals():
    import jax.numpy as jnp

    from bigdl_tpu.parallel import to_virtual_layout as jvirt

    from bigdl_tpu_torch.models.convert import tree_leaves, tree_map
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import (make_pipeline_train_step,
                                          to_virtual_layout)

    init = _init()
    tree = tree_map(torch.from_numpy, init)
    virt = to_virtual_layout(tree, 2, 2)
    want = jvirt({"blocks": {k: jnp.asarray(a) for k, a in
                             init["blocks"].items()}}, 2, 2)
    for k, a in virt["blocks"].items():
        np.testing.assert_array_equal(a.numpy(), np.asarray(
            want["blocks"][k]))
    back = to_virtual_layout(virt, 2, 2, inverse=True)
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert torch.equal(a, b)
    # slot dicts recurse to their params-shaped trees
    slots = to_virtual_layout({"velocity": tree}, 2, 2)
    assert torch.equal(slots["velocity"]["blocks"]["wq"],
                       virt["blocks"]["wq"])
    with pytest.raises(ValueError, match="refusing to build a garbage"):
        to_virtual_layout(tree, 2, 3)
    model = TransformerLM(TransformerConfig(**CFG), device="cpu")

    class Mesh2:
        shape = {"pipe": 2}

        @staticmethod
        def coord(axis):
            return 0

    with pytest.raises(ValueError, match="not divisible by 2 pipeline "
                       "stages x 3 virtual"):
        make_pipeline_train_step(model, SGD(), Mesh2, virtual_stages=3)
    with pytest.raises(ValueError, match="must not set tp/sp"):
        make_pipeline_train_step(TransformerLM(
            TransformerConfig(**CFG), device="cpu", tp_axis="model"),
            SGD(), Mesh2)
    with pytest.raises(NotImplementedError, match="MoE-FFN"):
        make_pipeline_train_step(TransformerLM(
            TransformerConfig(**CFG, moe_experts=2), device="cpu"),
            SGD(), Mesh2)
