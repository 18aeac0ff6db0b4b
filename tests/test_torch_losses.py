"""The port's fused LM loss (bigdl_tpu_torch/ops/losses.py) and
ChunkedSoftmaxCE (bigdl_tpu_torch/nn/criterion.py) against the JAX
package's, at a tiny size (B=2, S<=32, E=16, V=40), inputs from a numpy
seed.

Tolerances (fp32): the chunked loss within 1e-6 absolute (a mean of
per-token LSEs over a 40-wide vocabulary), its gradients with respect
to hidden and head within 1e-5 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.ops.losses import build_train_loss as jbuild
from bigdl_tpu.ops.losses import softmax_cross_entropy_chunked as jce
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.ops.losses import build_train_loss as tbuild
from bigdl_tpu_torch.ops.losses import softmax_cross_entropy_chunked as tce

LOSS_ATOL = 1e-6
GRAD_ATOL = 1e-5


def _inputs(b, s, e, v, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, e).astype(np.float32),
            (rng.randn(e, v) * 0.3).astype(np.float32),
            rng.randint(0, v, (b, s)).astype(np.int32))


@pytest.mark.parametrize("s, chunk", [(32, 8), (24, 16), (32, 256)],
                         ids=["divides", "largest_divisor", "one_chunk"])
def test_chunked_ce_and_grads_match_jax(s, chunk):
    h, w, t = _inputs(2, s, 16, 40)
    jl, (jgh, jgw) = jax.value_and_grad(
        lambda h, w: jce(h, w, jnp.asarray(t), chunk=chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tl = tce(th, tw, torch.from_numpy(t), chunk=chunk)
    tl.backward()
    assert abs(tl.item() - float(jl)) <= LOSS_ATOL
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh),
                               atol=GRAD_ATOL, rtol=0)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw),
                               atol=GRAD_ATOL, rtol=0)


def test_no_usable_chunk_raises_like_jax():
    h, w, t = _inputs(1, 37, 8, 10)   # prime S: largest divisor 1
    with pytest.raises(ValueError, match="no usable chunk size"):
        jce(jnp.asarray(h), jnp.asarray(w), jnp.asarray(t), chunk=16)
    with pytest.raises(ValueError, match="no usable chunk size"):
        tce(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(t),
            chunk=16)


def test_chunked_ce_under_no_grad_matches():
    h, w, t = _inputs(2, 32, 16, 40, seed=1)
    with torch.no_grad():
        a = tce(*map(torch.from_numpy, (h, w, t)), chunk=8)
    b = tce(*map(torch.from_numpy, (h, w, t)), chunk=8)
    assert float(a) == float(b)


def test_criterion_forward_on_log_probs_matches_jax():
    rng = np.random.RandomState(2)
    lp = np.log(rng.dirichlet(np.ones(12), size=(3, 5))).astype(np.float32)
    t = rng.randint(0, 12, (3, 5)).astype(np.int32)
    j = jnn.ChunkedSoftmaxCE().forward(jnp.asarray(lp), jnp.asarray(t))
    p = tnn.ChunkedSoftmaxCE()(torch.from_numpy(lp), torch.from_numpy(t))
    assert abs(float(p) - float(j)) <= LOSS_ATOL


def _lm(**cfg):
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)

    return TransformerLM(TransformerConfig(**cfg), device="cpu")


class _Linear(tnn.Module):
    """A model without the hidden/head surface: no fusion."""

    def apply(self, variables, x, training=False, rng=None):
        return torch.log_softmax(x @ variables["params"]["w"], -1), {}


def test_fused_protocol_and_its_refusals():
    lm = _lm(vocab_size=40, dim=16, num_heads=2, num_layers=1,
             max_len=16)
    crit = tnn.ChunkedSoftmaxCE(chunk=8)
    assert callable(crit.fused_loss(lm))
    assert crit.fused_loss(_Linear()) is None
    with pytest.raises(ValueError, match="non-empty state"):
        crit.fused_loss(lm)({"params": lm.init_params(),
                             "state": {"running": torch.zeros(1)}},
                            torch.zeros(1, 16, dtype=torch.long),
                            torch.zeros(1, 16, dtype=torch.long), None)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "apply"])
def test_build_train_loss_matches_jax(fused):
    """The fused path (ChunkedSoftmaxCE + TransformerLM) and the plain
    apply + criterion path both agree with the JAX construction."""
    from bigdl_tpu.models.transformer import build_lm as jlm
    from bigdl_tpu_torch.models.convert import params_from_jax

    cfg = dict(vocab_size=40, dim=16, num_heads=2, num_layers=1,
               max_len=16)
    jm = jlm(**cfg)
    variables = jm.init(jax.random.PRNGKey(1))
    tm = _lm(**cfg)
    params = params_from_jax(jax.device_get(variables["params"]),
                             device="cpu")
    rng = np.random.RandomState(3)
    x = rng.randint(0, 40, (2, 16)).astype(np.int32)
    y = rng.randint(0, 40, (2, 16)).astype(np.int32)
    if fused:
        jc, tc = jnn.ChunkedSoftmaxCE(chunk=8), tnn.ChunkedSoftmaxCE(chunk=8)
    else:
        jc, tc = _JaxNLL(), _NLL()
    jl, _ = jbuild(jm, jc)(variables["params"], {}, jnp.asarray(x),
                           jnp.asarray(y), None)
    tl, _ = tbuild(tm, tc)(params, {}, torch.from_numpy(x),
                           torch.from_numpy(y), None)
    assert abs(tl.item() - float(jl)) <= LOSS_ATOL


class _NLL(tnn.Criterion):
    """Mean NLL over (B, S, V) log-probs — the unfused criterion."""

    def forward(self, input, target):
        return -input.gather(-1, target.long()[..., None]).mean()


class _JaxNLL(jnn.Criterion):
    def forward(self, input, target):
        return -jnp.take_along_axis(input, target[..., None], -1).mean()
