"""Mixture-of-experts of the port (bigdl_tpu_torch/parallel/moe.py)
against the JAX package's MoE, after tests/test_moe.py and the
expert-parallel legs of __graft_entry__.py (`_dryrun_moe`).

In this process: top-1 (Switch), top-2 (GShard) and expert-choice
routing at small widths, with capacities small enough to drop tokens —
forward, aux and the gradients of the input and every parameter
against the JAX layer's dense one-hot einsums (the port dispatches
with indices; the values are the same). On two gloo ranks (spawned
once; this module imports JAX only inside its tests): the layer with
its experts split over an `expert` axis of 2 against the port's
single-device layer over each rank's tokens, and the MoE-FFN LM's
expert-parallel step (`make_moe_lm_train_step`) against the JAX
package's on two of the CPU devices that tests/conftest.py forces.

Tolerances (fp32): outputs, aux and losses within 1e-5 absolute (the
expert-parallel layer's summed loss, near 150, within 1e-6 relative);
gradients within 1e-5 absolute; parameters after a step within 1e-5
relative (1e-6 absolute floor). The tests rely on seeded random gates
having no ties (`lax.top_k` and `torch.topk` may order ties
differently).
"""

import numpy as np
import pytest
import torch

D, F, E, T = 8, 16, 4, 32
TOL = 1e-5
ROUTINGS = {"top1": dict(top_k=1, capacity_factor=0.5),
            "top2": dict(top_k=2, capacity_factor=0.5),
            "expert_choice": dict(routing="expert_choice",
                                  capacity_factor=1.0)}
LM_CFG = dict(vocab_size=32, max_len=16, dim=16, num_heads=4, num_layers=2,
              moe_experts=4, moe_top_k=2, moe_capacity_factor=1.25)


def _params(seed=0, e=E, d=D, f=F):
    rng = np.random.RandomState(seed)
    return {"router": rng.randn(d, e).astype(np.float32),
            "w1": (rng.randn(e, d, f) / np.sqrt(d)).astype(np.float32),
            "b1": (0.1 * rng.randn(e, f)).astype(np.float32),
            "w2": (rng.randn(e, f, d) / np.sqrt(f)).astype(np.float32),
            "b2": (0.1 * rng.randn(e, d)).astype(np.float32)}


def _x(seed=1, t=T, d=D):
    return np.random.RandomState(seed).randn(t, d).astype(np.float32)


def _port_moe_loss(moe, params, x, w):
    """(y, aux, loss, grads {name: array, "x": array}) of the port."""
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    (y, aux), _ = moe.apply({"params": p}, xt)
    loss = (y * torch.from_numpy(w)).sum() + 0.1 * aux
    names = sorted(p)
    grads = torch.autograd.grad(loss, [p[k] for k in names] + [xt])
    g = dict(zip(names + ["x"], (t.numpy() for t in grads)))
    return y.detach().numpy(), float(aux.detach()), float(loss.detach()), g


@pytest.mark.parametrize("routing", sorted(ROUTINGS))
def test_moe_matches_jax(routing):
    import jax
    import jax.numpy as jnp

    from bigdl_tpu.parallel import MoE as JMoE

    from bigdl_tpu_torch.parallel import MoE

    kw = ROUTINGS[routing]
    params, x = _params(), _x()
    w = np.random.RandomState(2).randn(T, D).astype(np.float32)
    jm = JMoE(D, F, E, **kw)

    def jloss(p, x):
        (y, aux), _ = jm.apply({"params": p, "state": {}}, x)
        return jnp.sum(y * w) + 0.1 * aux, (y, aux)

    (jl, (jy, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    y, aux, loss, g = _port_moe_loss(MoE(D, F, E, **kw), params, x, w)
    np.testing.assert_allclose(y, np.asarray(jy), atol=TOL, rtol=0)
    np.testing.assert_allclose(aux, float(jaux), atol=TOL, rtol=0)
    np.testing.assert_allclose(loss, float(jl), atol=TOL, rtol=0)
    for k, v in jg.items():
        np.testing.assert_allclose(g[k], np.asarray(v), atol=TOL, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(g["x"], np.asarray(jgx), atol=TOL, rtol=0)


def test_capacity_drops_and_gshard_queue_order():
    """The cases the JAX parity above must cover: top-1 drops tokens
    past capacity; top-2 second choices queue behind every first choice
    of their expert; a token whose second choice was dropped keeps its
    first at full weight, and one whose both choices survive splits its
    weight between them."""
    from bigdl_tpu_torch.parallel import MoE

    params, x = _params(), torch.from_numpy(_x())
    router = torch.from_numpy(params["router"])
    m1 = MoE(D, F, E, **ROUTINGS["top1"])
    (s1,), (g1,), _, cap1 = m1._route(x, router)
    assert int((s1 < 0).sum()) > 0 and cap1 == 4
    assert float(g1[s1 < 0].abs().max()) == 0.0

    m2 = MoE(D, F, E, **ROUTINGS["top2"])
    (s1, s2), (w1, w2), _, cap = m2._route(x, router)
    first = torch.bincount(torch.softmax(x @ router, -1).argmax(-1),
                           minlength=E)
    kept2 = s2 >= 0
    assert bool(((s2[kept2] % cap) >= first[s2[kept2] // cap]).all())
    only_first = (s1 >= 0) & ~kept2
    both = (s1 >= 0) & kept2
    assert int(only_first.sum()) > 0 and int(both.sum()) > 0
    np.testing.assert_allclose(w1[only_first].numpy(), 1.0, atol=1e-6)
    assert float(w2[only_first].abs().max()) == 0.0
    np.testing.assert_allclose((w1 + w2)[both].numpy(), 1.0, atol=1e-6)
    assert bool((w2[both] > 0).all() and (w2[both] <= w1[both]).all())


def test_refusals_as_jax():
    from bigdl_tpu_torch.parallel import MoE

    with pytest.raises(ValueError, match="top_k must be 1 or 2"):
        MoE(D, F, E, top_k=3)
    with pytest.raises(ValueError, match="routing must be"):
        MoE(D, F, E, routing="hash")
    with pytest.raises(ValueError, match="top_k has no meaning"):
        MoE(D, F, E, routing="expert_choice", top_k=2)


# --------------------------------------------------- expert parallelism
def _ep_layer(mesh, rank, world, top_k):
    """One rank's expert-parallel layer: its 16 tokens, its experts."""
    from bigdl_tpu_torch.parallel import MoE, moe_specs, shard_params
    from bigdl_tpu_torch.parallel.collectives import bind, psum_leaves

    params = _params(3, e=2 * world, d=16, f=32)
    p = shard_params(mesh, moe_specs("expert"),
                     {k: torch.from_numpy(v) for k, v in params.items()})
    p = {k: v.requires_grad_() for k, v in p.items()}
    x = torch.from_numpy(_x(4, t=16 * world, d=16)).chunk(world)[rank]
    moe = MoE(16, 32, 2 * world, expert_axis="expert", top_k=top_k)
    with bind(mesh):
        (y, aux), _ = moe.apply({"params": p}, x)
        loss = (y ** 2).sum() + 0.01 * aux
        names = sorted(p)
        grads = list(torch.autograd.grad(loss, [p[k] for k in names]))
        # the replicated router's per-rank partials are summed
        psum_leaves([grads[names.index("router")]], "expert")
        total = loss.detach().clone()
        psum_leaves([total], "expert")
    return float(total), {k: g.numpy() for k, g in zip(names, grads)}


def _ep_lm_step(mesh, init, toks, tgts):
    from bigdl_tpu_torch.models.convert import tree_leaves, tree_map
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import make_moe_lm_train_step, shard_params

    model = TransformerLM(TransformerConfig(**LM_CFG), device="cpu",
                          ep_axis="expert")
    method = SGD(learningrate=0.1)
    step = make_moe_lm_train_step(model, method, mesh, ep_axis="expert")
    params = shard_params(mesh, step.specs,
                          tree_map(torch.from_numpy, init))
    slots = method.init_slots(tree_leaves(params))
    params, _, loss = step(params, slots, torch.from_numpy(toks),
                           torch.from_numpy(tgts), 0.1, 0, 0)
    return float(loss), tree_map(lambda t: t.numpy(), params)


def _scenarios(rank, world, init, toks, tgts):
    from bigdl_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"expert": world}, device="cpu")
    return {"top1": _ep_layer(mesh, rank, world, 1),
            "top2": _ep_layer(mesh, rank, world, 2),
            "lm": _ep_lm_step(mesh, init, toks, tgts)}


def _lm_init():
    from bigdl_tpu_torch.models.convert import tree_map
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)

    m = TransformerLM(TransformerConfig(**LM_CFG), device="cpu")
    return tree_map(lambda t: t.numpy(),
                    m.init_params(torch.Generator().manual_seed(3)))


def _lm_batch():
    rng = np.random.RandomState(1)
    return (rng.randint(0, 32, (4, 16)).astype(np.int32),
            rng.randint(0, 32, (4, 16)).astype(np.int32))


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    from bigdl_tpu_torch.parallel.launch import spawn

    return spawn(_scenarios, 2, str(tmp_path_factory.mktemp("moe")),
                 _lm_init(), *_lm_batch())


@pytest.mark.parametrize("top_k", [1, 2])
def test_expert_parallel_layer_matches_one_device(w2, top_k):
    """Each rank routes its own tokens (capacity from its own count) and
    runs its experts on every rank's tokens: the summed loss and the
    gradients equal the single-device layer's over the same chunks."""
    from bigdl_tpu_torch.parallel import MoE

    world = len(w2)
    params = _params(3, e=2 * world, d=16, f=32)
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    moe = MoE(16, 32, 2 * world, top_k=top_k)
    total = 0
    for chunk in torch.from_numpy(_x(4, t=16 * world, d=16)).chunk(world):
        (y, aux), _ = moe.apply({"params": p}, chunk)
        total = total + (y ** 2).sum() + 0.01 * aux
    names = sorted(p)
    grads = dict(zip(names, torch.autograd.grad(total, [p[k]
                                                        for k in names])))
    for rank, res in enumerate(w2):
        loss, g = res[f"top{top_k}"]
        # a sum of squares near 150: fp32 resolves it to ~1.5e-5
        np.testing.assert_allclose(loss, float(total), atol=TOL, rtol=1e-6)
        np.testing.assert_allclose(g["router"], grads["router"].numpy(),
                                   atol=TOL, rtol=0)
        for k in ("w1", "b1", "w2", "b2"):
            mine = grads[k].chunk(world)[rank].numpy()
            np.testing.assert_allclose(g[k], mine, atol=TOL, rtol=0,
                                       err_msg=k)


def test_moe_lm_ep_step_matches_jax(w2):
    import jax
    import jax.numpy as jnp

    from bigdl_tpu.models.transformer import (TransformerConfig as JCfg,
                                              TransformerLM as JLM)
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu.parallel import make_mesh, make_moe_lm_train_step
    from bigdl_tpu.parallel import moe_lm_specs, shard_params
    from bigdl_tpu.parallel.tensor_parallel import slot_specs_for

    from bigdl_tpu_torch.models.convert import tree_leaves_with_path

    init = _lm_init()
    toks, tgts = _lm_batch()
    mesh = make_mesh({"expert": 2}, devices=jax.devices()[:2])
    method = JSGD(learningrate=0.1)
    specs = moe_lm_specs("expert")
    step = make_moe_lm_train_step(JLM(JCfg(**LM_CFG), ep_axis="expert"),
                                  method, mesh, ep_axis="expert")
    jp = jax.tree_util.tree_map(jnp.asarray, init)
    new_p, _, jloss = step(
        shard_params(mesh, specs, jp),
        shard_params(mesh, slot_specs_for(method, specs),
                     method.init_slots(jp)),
        jnp.asarray(toks), jnp.asarray(tgts), jnp.asarray(0.1),
        jnp.asarray(0), jax.random.PRNGKey(0))
    want = dict(tree_leaves_with_path(jax.device_get(new_p)))
    for rank, res in enumerate(w2):
        loss, params = res["lm"]
        np.testing.assert_allclose(loss, float(jloss), atol=TOL, rtol=0)
        for path, got in tree_leaves_with_path(params):
            full = want[path]
            if path[-1] in ("w1", "b1", "w2", "b2"):
                full = np.split(full, len(w2), axis=1)[rank]
            np.testing.assert_allclose(got, full, rtol=TOL, atol=1e-6,
                                       err_msg=str(path))
