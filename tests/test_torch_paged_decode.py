"""Paged-decode attention of the PyTorch port
(bigdl_tpu_torch/ops/paged_decode.py) against the JAX package's Pallas
kernel run in interpret mode (bigdl_tpu/ops/paged_decode.py), on the
same numpy inputs, over the JAX tests' block-table configurations.

Here, on the CPU, the port's `paged_decode_attention` takes its plain
PyTorch version; the CUDA kernel is held against that plain version on
the card by chip_smoke.py.

Tolerances: fp32 pools atol 1e-6, rtol 1e-5 (fp32 sums in two
frameworks, in different orders). bf16 pools atol 1e-5, rtol 1e-4:
both sides round the same fp32 values to bf16 (nearest even) and load
them to fp32, so the arithmetic is fp32 as well; the looser bound
leaves room for the two frameworks rounding bf16 at other places."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.paged_decode import \
    paged_decode_attention as jax_paged_decode
from bigdl_tpu_torch.ops import paged_decode
from bigdl_tpu_torch.ops.paged_decode import paged_decode_attention

FP32_TOL = dict(atol=1e-6, rtol=1e-5)
BF16_TOL = dict(atol=1e-5, rtol=1e-4)

CONFIGS = [
    # (b, h, nb, bs, d, block_tile, head_tile) — the JAX tests' rows
    (1, 1, 1, 4, 8, 1, 1),
    (2, 2, 4, 4, 8, 1, 1),
    (3, 4, 4, 4, 16, 1, 1),
    (1, 4, 4, 4, 8, 1, 2),
    (2, 2, 4, 4, 8, 2, 1),
    (2, 2, 4, 4, 8, 4, 2),
    (4, 8, 8, 16, 64, 8, 4),     # engine-like 43M shape
    (2, 1, 4, 4, 8, 1, 1),
]


def _case(b, h, nb, bs, d, seed=0, pos=None, poison=False):
    """Numpy pool + shuffled disjoint block chains + ragged clocks;
    block 0 is the reserved scratch block (NaN when `poison`)."""
    rng = np.random.RandomState(seed)
    n = b * nb + 1
    k_pool = rng.randn(n, h, bs, d).astype(np.float32)
    v_pool = rng.randn(n, h, bs, d).astype(np.float32)
    if poison:
        k_pool[0] = np.nan
        v_pool[0] = np.nan
    table = rng.permutation(np.arange(1, n))[:b * nb].reshape(b, nb)
    table = table.astype(np.int32)
    if pos is None:
        pos = rng.randint(0, nb * bs, size=b)
    pos = np.asarray(pos, np.int32)
    q = rng.randn(b, h, 1, d).astype(np.float32)
    return q, k_pool, v_pool, table, pos


def _both(args, dtype="float32", tiles=(None, None)):
    q, k, v, table, pos = args
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = jax_paged_decode(jnp.asarray(q), jnp.asarray(k, jd),
                           jnp.asarray(v, jd), jnp.asarray(table),
                           jnp.asarray(pos), impl="interpret",
                           block_tile=tiles[0], head_tile=tiles[1])
    out = paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k).to(td),
        torch.from_numpy(v).to(td), torch.from_numpy(table),
        torch.from_numpy(pos), impl="torch")
    return out.numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("b,h,nb,bs,d,bt,ht", CONFIGS)
def test_fp32_matches_jax_kernel(b, h, nb, bs, d, bt, ht):
    out, ref = _both(_case(b, h, nb, bs, d), tiles=(bt, ht))
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, **FP32_TOL)


def test_ragged_clocks():
    # clocks at 0, mid-block, at a block boundary and at the last key
    out, ref = _both(_case(4, 2, 4, 4, 8, pos=[0, 3, 4, 15]))
    np.testing.assert_allclose(out, ref, **FP32_TOL)


def test_poisoned_scratch_block_stays_out():
    out, ref = _both(_case(4, 2, 4, 4, 8, poison=True, pos=[0, 3, 4, 15]))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **FP32_TOL)


@pytest.mark.parametrize("cfg", [(2, 2, 4, 4, 8), (4, 8, 8, 16, 64)])
def test_bf16_pools(cfg):
    out, ref = _both(_case(*cfg, seed=3, poison=True), dtype="bfloat16")
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **BF16_TOL)


def test_default_impl_on_cpu_is_plain_version():
    q, k, v, table, pos = map(torch.from_numpy, _case(2, 2, 4, 4, 8))
    before = paged_decode.launches
    auto = paged_decode_attention(q, k, v, table, pos)
    plain = paged_decode_attention(q, k, v, table, pos, impl="torch")
    assert torch.equal(auto, plain)
    assert paged_decode.launches == before


def test_cuda_impl_on_cpu_tensors_raises():
    q, k, v, table, pos = map(torch.from_numpy, _case(2, 2, 4, 4, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_decode_attention(q, k, v, table, pos, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        paged_decode_attention(q, k, v, table, pos, impl="pallas")
    with pytest.raises(ValueError, match="one row"):
        paged_decode_attention(q.expand(2, 2, 3, 8), k, v, table, pos)


def test_import_builds_nothing():
    # the kernel builds at its first launch, never at import: a process
    # without nvcc imports the module and runs the plain version
    code = ("import torch, bigdl_tpu_torch.ops.paged_decode as pd, "
            "bigdl_tpu_torch.ops._build as b; "
            "assert not b._LIBS and pd.launches == 0; "
            "q = torch.zeros(1, 1, 1, 32); p = torch.zeros(2, 1, 4, 32); "
            "t = torch.ones(1, 1, dtype=torch.int32); "
            "c = torch.zeros(1, dtype=torch.int32); "
            "pd.paged_decode_attention(q, p, p, t, c); "
            "assert not b._LIBS and pd.launches == 0")
    env = {"PATH": "/nonexistent", "PYTHONPATH": ":".join(sys.path)}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_shared_memory_estimate_matches_kernel_layout():
    # 16 reduction slots + 16 partial rows of D + one score per key +
    # the staged table row
    assert paged_decode.shared_bytes(37, 16, 64) == \
        4 * (16 + 16 * 64 + 592 + 37)
