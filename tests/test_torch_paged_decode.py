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
    # csrc/paged_decode.cu's layout at the engine shape (37 blocks of 16,
    # D = 64, split 8 x 80 keys): the CTA's result (m, l and D floats,
    # from float 4 on), a ring of 4 stages of (16 K rows, 16 V rows) of
    # D fp32 (16 threads a key, 2 keys a group of 8) or (32 K, 32 V) of D
    # bf16 (8 threads a key), and the table slice of 80 / 16 + 1 pages
    assert paged_decode.split_plan(37, 16) == (8, 80)
    assert paged_decode.shared_bytes(37, 16, 64, 4) == \
        4 * (64 + 4) + 4 * 4 * 2 * 16 * 64 + 4 * (80 // 16 + 1)
    assert paged_decode.shared_bytes(37, 16, 64, 2) == \
        4 * (64 + 4) + 2 * 4 * 2 * 32 * 64 + 4 * (80 // 16 + 1)


@pytest.mark.parametrize("nb,bs", [(1, 1), (1, 16), (3, 4), (37, 16),
                                   (40, 16), (256, 16), (9, 4), (5, 8),
                                   (1000, 1), (64, 64)])
def test_split_plan_covers_each_key_once(nb, bs):
    splits, span = paged_decode.split_plan(nb, bs)
    seq = nb * bs
    assert 1 <= splits <= paged_decode.MAX_SPLITS
    assert span % paged_decode.SPLIT_ALIGN == 0
    covered = [j for r in range(splits)
               for j in range(r * span, min((r + 1) * span, seq))]
    assert covered == list(range(seq))            # once each, in order
    assert (splits - 1) * span < seq              # no empty last rank
    for d in range(32, 257, 32):
        for itemsize in (2, 4):
            assert paged_decode.shared_bytes(nb, bs, d, itemsize) \
                <= paged_decode.MAX_SHARED_BYTES


def test_split_plan_depends_on_the_extent_alone():
    # the plan takes the table extent and nothing else, so a row's bits
    # cannot depend on its co-batch (B) or on the clocks; the engine's
    # shape gets 8 CTAs a (row, head), 512 at B = H = 8
    import inspect
    assert list(inspect.signature(paged_decode.split_plan).parameters) \
        == ["num_blocks", "block_size"]
    assert paged_decode.split_plan(592 // 16, 16) == (8, 80)
    assert paged_decode.split_plan(1, 16) == (1, 16)
    assert paged_decode.split_plan(256, 16) == (8, 512)


@pytest.mark.parametrize("nb,bs,pos", [(37, 16, [0, 591, 300, 79, 80]),
                                       (9, 4, [35, 0, 17]),
                                       (256, 16, [0, 2047, 4095])])
def test_split_online_softmax_combine_matches_plain(nb, bs, pos):
    """The kernel's arithmetic over the split plan in plain PyTorch: each
    rank's online softmax over its visible keys (-inf / 0 / nothing when
    it has none), combined in rank order, equals the plain version, with
    NaN in the rows past each clock and in the scratch block."""
    b, h, d = len(pos), 2, 32
    q, k, v, table, pos = map(torch.from_numpy, _case(
        b, h, nb, bs, d, seed=5, pos=pos, poison=True))
    for r in range(b):
        blk = table[r, int(pos[r]) // bs]
        k[blk, :, int(pos[r]) % bs + 1:] = float("nan")
        v[blk, :, int(pos[r]) % bs + 1:] = float("nan")
        table[r, int(pos[r]) // bs + 1:] = 0
    scale = d ** -0.5
    splits, span = paged_decode.split_plan(nb, bs)
    out = torch.empty(b, h, 1, d)
    for r in range(b):
        n = int(pos[r]) + 1
        for hh in range(h):
            parts = []
            for rank in range(splits):
                m, l, acc = float("-inf"), 0.0, torch.zeros(d)
                for j in range(rank * span, min((rank + 1) * span, n)):
                    blk = int(table[r, j // bs])
                    s = float(q[r, hh, 0] @ k[blk, hh, j % bs]) * scale
                    mn = max(m, s)
                    corr = np.exp(m - mn) if m != float("-inf") else 0.0
                    p = np.exp(s - mn)
                    l = l * corr + p
                    acc = acc * corr + p * v[blk, hh, j % bs]
                    m = mn
                parts.append((m, l, acc))
            fm = max(pm for pm, _, _ in parts)
            live = [(pm, pl, pa) for pm, pl, pa in parts
                    if pm != float("-inf")]
            fl = sum(pl * np.exp(pm - fm) for pm, pl, _ in live)
            out[r, hh, 0] = sum(pa * float(np.exp(pm - fm))
                                for pm, _, pa in live) / fl
    ref = paged_decode_attention(q, k, v, table, pos, impl="torch")
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **FP32_TOL)
