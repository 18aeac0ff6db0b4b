"""The import slice as a whole, on the CPU: the JAX package exports
`models/vgg.build_cifar` (conv-bn-relu stacks, a 512-unit head with a
1-D batch norm and dropout) through its TensorFlow saver; both
packages' loaders import the GraphDef, and each package fine-tunes its
import for two SGD steps (lr 0.01, training mode: batch statistics; the
saver writes dropout as Identity) on the same seeded batch. The port's
variables equal the JAX package's bit for bit at import, and its
losses and gradients stay within 1e-4 of them (relative to the largest
gradient of each leaf) at both steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import vgg as jvgg
from bigdl_tpu.utils import tf as jtf
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.models.convert import (tree_leaves, tree_map,
                                            variables_from_jax)
from bigdl_tpu_torch.utils import tf as ptf

TOL = 1e-4
BATCH, STEPS, LR = 1, 2, 0.01


def test_vgg_cifar_exported_imported_and_fine_tuned(tmp_path):
    src = jvgg.build_cifar(10)
    # seeded weights drawn by numpy (eager JAX init of 30 tensors costs
    # seconds of compiles): He-normal kernels; vectors (biases, batch
    # norm scales and running statistics) in [0.5, 1)
    rng = np.random.default_rng(3)

    def draw(s):
        if len(s.shape) == 1:
            return rng.uniform(0.5, 1.0, s.shape).astype(s.dtype)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape)
                * np.sqrt(2.0 / fan_in)).astype(s.dtype)

    sv = jax.tree_util.tree_map(draw, jax.eval_shape(
        src.init, jax.random.PRNGKey(3)))
    path = str(tmp_path / "vgg_cifar.pb")
    jtf.save(src, sv, path, (1, 32, 32, 3))

    # the JAX loader draws a full init before it overwrites every
    # imported leaf: threefry on the CPU takes ~15 s for VGG's 15M
    # parameters, the counter-based generator ~3 s (no value survives)
    prev_impl = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "unsafe_rbg")
    try:
        jm, jv = jtf.load(path)
    finally:
        jax.config.update("jax_default_prng_impl", prev_impl)
    tm, tv = ptf.load(path, device="cpu")
    want = variables_from_jax(jax.device_get(jv), device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(tv), tree_leaves(want)))

    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, 32, 32, 3))
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    jcrit, tcrit = jnn.ClassNLLCriterion(), pnn.ClassNLLCriterion()
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        jlosses, jgrads = _jax_steps(jm, jv, x, y, jcrit)
    finally:
        jax.config.update("jax_enable_x64", prev)

    tp = tree_map(lambda t: t.double(), tv["params"])
    ts = tree_map(lambda t: t.double(), tv["state"])
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for step in range(STEPS):
        leaves = [t.requires_grad_() for t in tree_leaves(tp)]
        out, ts = tm.apply({"params": tp, "state": ts}, xt, training=False)
        loss = tcrit(out, yt)
        grads = torch.autograd.grad(loss, leaves)
        np.testing.assert_allclose(float(loss), jlosses[step], rtol=TOL,
                                   err_msg=f"step {step}")
        assert len(jgrads[step]) == len(grads)
        for g, jg in zip(grads, jgrads[step]):
            scale = max(1e-3, float(np.abs(jg).max()))
            assert float(np.abs(g.numpy() - jg).max()) <= TOL * scale, step
        with torch.no_grad():
            tp = tree_map(lambda p: p.detach(), tp)
            for p, g in zip(tree_leaves(tp), grads):
                p -= LR * g
        ts = tree_map(lambda s: s.detach(), ts)
    assert all(np.isfinite(jlosses))


def _jax_steps(jm, jv, x, y, crit):
    """STEPS SGD steps of the JAX import in fp64: losses and gradients
    (leaves as host arrays) of each."""
    f64 = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), t)
    params, state = f64(jv["params"]), f64(jv["state"])

    @jax.jit
    def step(params, state):
        def loss_fn(p):
            out, new_state = jm.apply({"params": p, "state": state},
                                      jnp.asarray(x), training=False)
            return crit(out, jnp.asarray(y)), new_state
        (loss, new_state), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        params = jax.tree_util.tree_map(lambda p, g: p - LR * g, params,
                                        grads)
        return loss, grads, params, new_state

    losses, grads = [], []
    for _ in range(STEPS):
        loss, g, params, state = step(params, state)
        losses.append(float(loss))
        grads.append(jax.tree_util.tree_leaves(jax.device_get(g)))
    return losses, grads
