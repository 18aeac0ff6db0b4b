"""Tensor and sequence parallelism of the port's Transformer-LM
(bigdl_tpu_torch/parallel/tensor_parallel.py) on four gloo ranks, after
tests/test_tensor_parallel.py and __graft_entry__.py's `_dryrun_tp_sp`:
the dp×tp×sp step on a {"data": 1, "model": 2, "seq": 2} mesh, with
ring and with zigzag sequence parallelism, against the JAX package's
step on the same mesh of the CPU devices that tests/conftest.py forces
and against the single-device loss; the loss falls over 3 steps; the
axis refusals are the JAX package's.

The ranks are spawned once; they return every step's loss and the
parameters after the first and the last step, gathered (this module
imports JAX only inside its tests). Tolerances (fp32): losses within
1e-5 absolute; parameters after a step within 1e-5 relative (1e-6
absolute floor) — SGD with momentum 0.9, so the step moves each weight
by lr times its gradient.
"""

import numpy as np
import pytest
import torch

CFG = dict(vocab_size=64, max_len=32, dim=32, num_heads=4, num_layers=2)
MESH = {"data": 1, "model": 2, "seq": 2}
STEPS, LR = 3, 0.1
TOL = 1e-5


def _init():
    from bigdl_tpu_torch.models.convert import tree_map
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)

    m = TransformerLM(TransformerConfig(**CFG), device="cpu")
    return tree_map(lambda t: t.numpy(),
                    m.init_params(torch.Generator().manual_seed(0)))


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 64, (2, 32)).astype(np.int32),
            rng.randint(0, 64, (2, 32)).astype(np.int32))


def _scenarios(rank, world, init):
    from bigdl_tpu_torch.models.convert import tree_leaves, tree_map
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import (make_mesh,
                                          make_transformer_train_step,
                                          shard_params)
    from bigdl_tpu_torch.parallel.tensor_parallel import gather_params

    mesh = make_mesh(MESH, device="cpu")
    toks, tgts = (torch.from_numpy(a) for a in _batch())
    out = {}
    for mode in ("ring", "zigzag"):
        model = TransformerLM(TransformerConfig(**CFG), device="cpu",
                              tp_axis="model", sp_axis="seq", sp_mode=mode)
        method = SGD(learningrate=LR, momentum=0.9)
        step = make_transformer_train_step(model, method, mesh, "data",
                                           "model", "seq")
        params = shard_params(mesh, step.specs,
                              tree_map(torch.from_numpy, init))
        slots = method.init_slots(tree_leaves(params))
        losses, trees = [], []
        for i in range(STEPS):
            params, slots, loss = step(params, slots, toks, tgts, LR, i, 1)
            losses.append(float(loss))
            if i in (0, STEPS - 1):
                trees.append(tree_map(lambda t: t.numpy(), gather_params(
                    mesh, step.specs, params)))
        out[mode] = (losses, trees)
    return out


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    from bigdl_tpu_torch.parallel.launch import spawn

    return spawn(_scenarios, 4, str(tmp_path_factory.mktemp("tp")),
                 _init())


def _single_device_loss():
    from bigdl_tpu_torch.models.convert import tree_map
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)

    toks, tgts = (torch.from_numpy(a) for a in _batch())
    m = TransformerLM(TransformerConfig(**CFG), device="cpu")
    logp, _ = m.apply({"params": tree_map(torch.from_numpy, _init())}, toks)
    return float(-logp.gather(-1, tgts.long()[..., None]).mean())


def _jax_steps(mode):
    import jax
    import jax.numpy as jnp

    from bigdl_tpu.models.transformer import (TransformerConfig as JCfg,
                                              TransformerLM as JLM)
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu.parallel import (make_mesh, make_transformer_train_step,
                                    shard_params, slot_specs_for,
                                    transformer_tp_specs)

    mesh = make_mesh(MESH, devices=jax.devices()[:4])
    model = JLM(JCfg(**CFG), tp_axis="model", sp_axis="seq", sp_mode=mode)
    method = JSGD(learningrate=LR, momentum=0.9)
    specs = transformer_tp_specs("model")
    step = make_transformer_train_step(model, method, mesh, "data", "model",
                                       "seq")
    p = jax.tree_util.tree_map(jnp.asarray, _init())
    slots = shard_params(mesh, slot_specs_for(method, specs),
                         method.init_slots(p))
    p = shard_params(mesh, specs, p)
    args = (p, slots) + tuple(jnp.asarray(a) for a in _batch()) + (
        jnp.asarray(LR), jnp.asarray(0), jax.random.PRNGKey(1))
    # backend optimisation 0: half the compile time, the same HLO
    p, slots, loss = step.lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)
    return float(loss), jax.device_get(p)


@pytest.mark.parametrize("mode", ["ring", "zigzag"])
def test_dp_tp_sp_step_matches_jax_and_one_device(w4, mode):
    from bigdl_tpu_torch.models.convert import tree_leaves_with_path

    jloss, jparams = _jax_steps(mode)
    ref = _single_device_loss()
    want = dict(tree_leaves_with_path(jparams))
    for res in w4:
        losses, trees = res[mode]
        np.testing.assert_allclose(losses[0], jloss, atol=TOL, rtol=0)
        np.testing.assert_allclose(losses[0], ref, atol=TOL, rtol=0)
        for path, got in tree_leaves_with_path(trees[0]):
            np.testing.assert_allclose(got, want[path], rtol=TOL,
                                       atol=1e-6, err_msg=str(path))


@pytest.mark.parametrize("mode", ["ring", "zigzag"])
def test_loss_falls_over_three_steps(w4, mode):
    for res in w4:
        losses, trees = res[mode]
        assert losses == w4[0][mode][0]        # every rank: the same loss
        assert losses[0] > losses[1] > losses[2], losses
    # the two layouts train the same model (the permutation leaves the
    # mean loss and every gradient unchanged)
    np.testing.assert_allclose(w4[0]["ring"][0], w4[0]["zigzag"][0],
                               atol=TOL, rtol=0)


def test_axis_refusals_as_jax():
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import make_transformer_train_step

    cfg = TransformerConfig(**CFG)
    tp = TransformerLM(cfg, device="cpu", tp_axis="model")
    with pytest.raises(ValueError, match="model.tp_axis='model' != step "
                       "tp_axis='x'"):
        make_transformer_train_step(tp, SGD(), None, tp_axis="x")
    with pytest.raises(ValueError, match="model.sp_axis=None != step "
                       "sp_axis='seq'"):
        make_transformer_train_step(tp, SGD(), None, sp_axis="seq")
    moe = TransformerLM(TransformerConfig(**CFG, moe_experts=2),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="MoE-FFN"):
        make_transformer_train_step(moe, SGD(), None, tp_axis=None)
