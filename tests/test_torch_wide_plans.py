"""The layouts of the two kernels that run above the tiers, which need no
card to check: K1's row-split kernel above D = 1024
(bigdl_tpu_torch/ops/paged_decode.py `wide_plan`, `wide_copy_bytes`,
mirroring csrc/paged_decode.cu "D > 1024") and the bf16 flash forward
above D = 256 (bigdl_tpu_torch/ops/flash_attention.py `wide_fwd_plan`,
mirroring csrc/flash_attention.cu WideFwd), and the bf16 flash backward
above D = 256 (`wide_bwd_plan`, mirroring WideBwd and
launch_bwd_wide_bf16). The CUDA kernels cannot run here (no nvcc, no
card): chip_smoke.py holds them to their plain versions on the card. The plain paged decode is held to the JAX kernel `_pd_kernel`
(interpret mode, as the JAX package's tests run it) at D = 2049 here,
beside tests/test_torch_head_dims.py's D = 1100 (fp32 pools atol 1e-6,
rtol 1e-5; bf16 pools atol 1e-5, rtol 1e-4, those of that file).

The K1 plan is a function of the table extent, the head dim and the
pools' itemsize alone (a row's bits may not depend on its co-batch or
the clocks); its arithmetic — each rank's stages of keys through one
online softmax, every score of a stage known before its V rows are
weighted, the ranks combined in order — is run here in plain PyTorch
against the plain version (fp32, atol 1e-6, rtol 1e-5: the same sums in
another order). The cluster backward's arithmetic at D = 384 and 512 —
each rank's partial S and dP over its own columns, summed in rank order,
then p, ds and each rank's columns of dq, dk and dv — is run here in
plain PyTorch against the JAX package's fused Pallas backward
(interpret mode) within FLASH_GRAD_RTOL of each gradient's max (fp32,
tests/test_torch_head_dims.py's tolerance: two frameworks' fp32 sums
over up to 512 columns)."""

import importlib
import inspect
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.paged_decode import \
    paged_decode_attention as jax_paged_decode
from bigdl_tpu_torch.ops import paged_decode as pd

tfa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")
jfa = importlib.import_module("bigdl_tpu.ops.flash_attention")
CSRC = Path(pd.__file__).resolve().parent / "csrc"
FP32_TOL = dict(atol=1e-6, rtol=1e-5)
BF16_TOL = dict(atol=1e-5, rtol=1e-4)
FLASH_GRAD_RTOL = 1e-4

WIDE_DIMS = (1025, 1100, 2049, 4096, 8192)
EXTENTS = [(6, 16), (37, 16), (1, 16), (256, 16), (9, 4), (3, 1)]


def _row_bytes(d, itemsize):
    return -(-d * itemsize // 16) * 16


@pytest.mark.parametrize("nb,bs", EXTENTS)
@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_k1_wide_plan_covers_each_key_once(d, itemsize, nb, bs):
    """Every key in one rank's range, in order, no rank empty; each rank
    at least WIDE_MIN_BYTES of K and V rows (or the only rank); a thread
    holds the fewest chunks (a power of two <= 8) that cover a row; the
    ring holds 8 / chunks keys a stage; the CTA fits the card's 227 KB."""
    plan = pd.wide_plan(nb, bs, d, itemsize)
    seq = nb * bs
    splits, span = plan["splits"], plan["span"]
    assert 1 <= splits <= pd.MAX_SPLITS
    covered = [j for r in range(splits)
               for j in range(r * span, min((r + 1) * span, seq))]
    assert covered == list(range(seq))
    assert (splits - 1) * span < seq
    assert splits == 1 or span * 2 * d * itemsize >= pd.WIDE_MIN_BYTES
    rowb = _row_bytes(d, itemsize)
    chunks = plan["chunks"]
    assert chunks in (1, 2, 4, 8)
    assert chunks * 256 * 16 >= rowb and (chunks == 1
                                          or chunks * 128 * 16 < rowb)
    assert plan["stage_keys"] * chunks == 8
    assert plan["smem"] == (3 * 2 * plan["stage_keys"] * rowb
                            + 4 * 8 * plan["stage_keys"]
                            + 4 * (-(-span // bs) + 1))
    assert plan["smem"] <= pd.MAX_SHARED_BYTES


def test_k1_wide_plan_depends_on_extent_and_head_dim_alone():
    """The plan's inputs, and what it gives at chip_smoke's d1100 case (4
    slots, 96 keys) and at D = 2049, 4096 and 8192 in both dtypes: 8
    ranks of 12 keys; chunks a thread 2 / 1 at D = 1100 (fp32 / bf16),
    4 / 2 at 2049 and 4096, 8 / 4 at 8192; under 227 KB throughout."""
    assert list(inspect.signature(pd.wide_plan).parameters) == [
        "num_blocks", "block_size", "head_dim", "itemsize"]
    want = {(1100, 4): (2, 4, 105736), (1100, 2): (1, 8, 106248),
            (2049, 4): (4, 2, 98568), (2049, 2): (2, 4, 98824),
            (4096, 4): (4, 2, 196680), (4096, 2): (2, 4, 196744),
            (8192, 4): (8, 1, 196648), (8192, 2): (4, 2, 196680)}
    for (d, itemsize), (chunks, keys, smem) in want.items():
        plan = pd.wide_plan(96 // 16, 16, d, itemsize)
        assert (plan["splits"], plan["span"]) == (8, 12), (d, itemsize)
        assert (plan["chunks"], plan["stage_keys"], plan["smem"]) \
            == (chunks, keys, smem), (d, itemsize)
    # the widest rows: 8 chunks of 16 bytes for each of 256 threads
    assert pd.wide_plan(6, 16, 16384, 2)["chunks"] == 8
    for d, itemsize in ((8193, 4), (16385, 2), (1024, 4), (512, 2)):
        with pytest.raises(ValueError, match="row-split kernel takes"):
            pd.wide_plan(6, 16, d, itemsize)


def test_k1_wide_copy_width():
    """16-byte copies for rows of whole 16-byte chunks, 8-byte ones for
    rows of whole 8-byte pieces, else the element: a bf16 row of D = 1100
    is 2200 bytes (8), an fp32 row of D = 2049 8196 (4), a bf16 row of
    odd D only 2-byte aligned (2); each only on pools that start on as
    many bytes."""
    f32, b16 = torch.zeros(64), torch.zeros(64, dtype=torch.bfloat16)
    cases = [(1100, f32, 16), (1100, b16, 8), (2049, f32, 4),
             (2049, b16, 2), (1025, f32, 4), (1026, b16, 2),
             (1028, b16, 8), (1026, f32, 8), (4096, b16, 16)]
    for d, t, want in cases:
        assert pd.wide_copy_bytes(d, t.element_size(), t, t) == want, d
    # pools off a 16- or 8-byte boundary take the element
    assert pd.wide_copy_bytes(1104, 2, b16[1:], b16[1:]) == 2
    assert pd.wide_copy_bytes(1104, 4, f32[2:], f32) == 8
    assert pd.wide_copy_bytes(1104, 4, f32[1:], f32) == 4


def _wide_case(b, h, nb, bs, d, pos, seed):
    rng = np.random.RandomState(seed)
    n = b * nb + 1
    k = torch.from_numpy(rng.randn(n, h, bs, d).astype(np.float32))
    v = torch.from_numpy(rng.randn(n, h, bs, d).astype(np.float32))
    table = torch.from_numpy(
        rng.permutation(np.arange(1, n))[:b * nb].reshape(b, nb)
        .astype(np.int32))
    pos = torch.tensor(pos, dtype=torch.int32)
    for r in range(b):          # NaN past each clock, the scratch block 0
        blk = table[r, int(pos[r]) // bs]
        k[blk, :, int(pos[r]) % bs + 1:] = float("nan")
        v[blk, :, int(pos[r]) % bs + 1:] = float("nan")
        table[r, int(pos[r]) // bs + 1:] = 0
    k[0] = v[0] = float("nan")
    q = torch.from_numpy(rng.randn(b, h, 1, d).astype(np.float32))
    return q, k, v, table, pos


@pytest.mark.parametrize("d,nb,bs,pos", [(1100, 6, 16, [0, 95, 40]),
                                         (2049, 9, 4, [35, 3, 12]),
                                         (4096, 2, 16, [31, 0, 17])])
def test_k1_wide_arithmetic_matches_plain(d, nb, bs, pos):
    """The row-split kernel's arithmetic over wide_plan in plain PyTorch:
    each rank's visible keys in stages of stage_keys, a stage's scores all
    taken before its running max and sum update and its V rows are
    weighted, keys past the clock never read (NaN there); the ranks'
    (m, l, acc) combined in rank order. Equals the plain version."""
    b, h = len(pos), 2
    q, k, v, table, pos = _wide_case(b, h, nb, bs, d, pos, seed=d)
    plan = pd.wide_plan(nb, bs, d, 4)
    splits, span, sk = plan["splits"], plan["span"], plan["stage_keys"]
    scale = d ** -0.5
    out = torch.empty(b, h, 1, d, dtype=torch.float64)
    for r in range(b):
        n = int(pos[r]) + 1
        for hh in range(h):
            parts = []
            for rank in range(splits):
                keys = list(range(rank * span, min((rank + 1) * span, n)))
                m, l = float("-inf"), 0.0
                acc = torch.zeros(d, dtype=torch.float64)
                for s0 in range(0, len(keys), sk):
                    stage = keys[s0:s0 + sk]
                    rows = [(int(table[r, j // bs]), j % bs) for j in stage]
                    sc = [float(q[r, hh, 0].double()
                                @ k[blk, hh, o].double()) * scale
                          for blk, o in rows]
                    mn = max([m] + sc)
                    corr = np.exp(m - mn) if m != float("-inf") else 0.0
                    l, acc = l * corr, acc * corr
                    for (blk, o), x in zip(rows, sc):
                        p = np.exp(x - mn)
                        l += p
                        acc = acc + p * v[blk, hh, o].double()
                    m = mn
                parts.append((m, l, acc))
            fm = max(pm for pm, _, _ in parts)
            live = [x for x in parts if x[0] != float("-inf")]
            fl = sum(pl * np.exp(pm - fm) for pm, pl, _ in live)
            out[r, hh, 0] = sum(pa * float(np.exp(pm - fm))
                                for pm, _, pa in live) / fl
    ref = pd.paged_decode_attention(q, k, v, table, pos, impl="torch")
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), **FP32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_matches_jax_kernel_at_2049(dtype):
    """K1's plain version against the Pallas kernel (interpret) at D =
    2049: 8196-byte fp32 rows, 4098-byte bf16 rows (the row-split
    kernel's 4-byte and element-wise copies on the card)."""
    rng = np.random.RandomState(2049)
    b, h, nb, bs, d = 3, 2, 4, 4, 2049
    n = b * nb + 1
    k = rng.randn(n, h, bs, d).astype(np.float32)
    v = rng.randn(n, h, bs, d).astype(np.float32)
    table = rng.permutation(np.arange(1, n))[:b * nb].reshape(b, nb) \
        .astype(np.int32)
    pos = rng.randint(0, nb * bs, size=b).astype(np.int32)
    pos[0] = nb * bs - 1
    q = rng.randn(b, h, 1, d).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = jax_paged_decode(jnp.asarray(q), jnp.asarray(k, jd),
                           jnp.asarray(v, jd), jnp.asarray(table),
                           jnp.asarray(pos), impl="interpret")
    out = pd.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k).to(td),
        torch.from_numpy(v).to(td), torch.from_numpy(table),
        torch.from_numpy(pos))
    assert out.shape == (b, h, 1, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                               **(BF16_TOL if dtype == "bfloat16"
                                  else FP32_TOL))


def test_k1_wide_constants_mirror_the_kernel():
    src = (CSRC / "paged_decode.cu").read_text()
    assert "constexpr int kWideThreads = 256;" in src
    assert "constexpr int kWideStages = 3;" in src
    assert re.search(r"wide_stage_keys\(\) \{\s*return 8 / NCH;", src)
    for n in (1, 2, 4, 8):
        assert f"BIGDL_PDW_CASE({n})" in src
    assert (pd._WIDE_THREADS, pd._WIDE_STAGES, pd._WIDE_MAX_CHUNKS) \
        == (256, 3, 8)


@pytest.mark.parametrize("dp", range(384, 4097, 128))
def test_flash_wide_forward_plan(dp):
    """The bf16 forward's layout at every padded head dim from 384 to
    4096: D = 384 and 512 one CTA of 2 warpgroups (3 and 4 sub-tiles of 64
    columns each, the partial scores summed in shared memory), above a
    cluster of one-warpgroup CTAs of 4 sub-tiles (portable up to 8 ranks,
    then up to 16); every warpgroup's first sub-tile inside D, the
    sub-tiles covering D, the CTA within 227 KB."""
    plan = tfa.wide_fwd_plan(dp)
    nsub = dp // 64
    ranks, wgs, subs = plan["ranks"], plan["warpgroups"], plan["subs"]
    assert (ranks - 1) * wgs * subs < nsub <= ranks * wgs * subs
    assert all((r * wgs + w) * subs < nsub
               for r in range(ranks) for w in range(wgs))
    if dp <= 512:
        assert (ranks, wgs, subs) == (1, 2, nsub // 2)
        assert plan["k_buffers"] == (2 if dp == 384 else 1)
    else:
        assert (wgs, subs, plan["k_buffers"]) == (1, 4, 1)
        assert ranks == -(-nsub // 4) >= 2
    assert plan["rows"] == 64
    assert plan["portable"] == (ranks <= 8) and ranks <= 16
    assert plan["smem"] == (1024 + (2 + plan["k_buffers"]) * wgs * subs
                            * 64 * 64 * 2
                            + (2 if ranks > 1 else 1) * wgs * 64 * 64 * 4
                            + 8 * (plan["k_buffers"] + 1))
    assert plan["smem"] <= tfa.MAX_SHARED_BYTES


def test_flash_wide_forward_refuses_outside_its_range():
    """bf16 stops at BF16_MAX_HEAD_DIM (64 sub-tiles: 16 ranks of 4);
    fp32 keeps its own limit; up to 256 the instantiations run."""
    assert tfa.BF16_MAX_HEAD_DIM == 4096
    assert tfa.column_slices(4096, torch.bfloat16) == 32
    with pytest.raises(ValueError, match="bf16 kernels take head dims"):
        tfa.column_slices(4096 + 128, torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 kernels take head dims"):
        tfa.wide_fwd_plan(4096 + 128)
    with pytest.raises(ValueError, match="the layout above 256"):
        tfa.wide_fwd_plan(256)
    assert tfa.column_slices(2048, torch.float32) == 1
    src = (CSRC / "flash_attention.cu").read_text()
    assert "constexpr int kWideFwdMaxSubs = 64;" in src
    for args in ("2, 3, 2", "2, 4, 1", "1, 4, 1"):
        assert f"launch_fwd_wide_plan<{args}>" in src


def test_flash_forward_returns_one_lse_row():
    """The forward's wrapper returns (out, lse) with one (BH, S) lse row
    at every D; nothing asks for per-slice rows any more."""
    assert list(inspect.signature(tfa.flash_fwd_cuda).parameters) == [
        "q", "k", "v", "causal", "sm_scale"]
    q = torch.randn(2, 5, 320)
    out, lse = tfa.attention_reference(q, q, q, True, 0.1, return_lse=True)
    assert out.shape == q.shape and lse.shape == (2, 5)


@pytest.mark.parametrize("dp", range(384, 4097, 128))
def test_flash_wide_backward_plan(dp):
    """The bf16 backward's layout at every padded head dim from 384 to
    4096: at D = 384 and 512 a cluster of 2 CTAs of D / 2 columns, 2
    warpgroups each, S and dP once a tile pair; above, one CTA of one
    warpgroup a 128-column slice, S and dP once a slice. The ranks'
    columns cover D once; the CTA fits the card's 227 KB; a thread's
    accumulators, beside a 64 x 64 score tile (32 registers) and its
    bf16 operand (16), stay under 255 registers, and one CTA's threads
    under the SM's 65,536; the route is the one csrc/flash_attention.cu
    dispatches, with the shared memory its WideBwd (or the slices')
    arithmetic gives."""
    plan = tfa.wide_bwd_plan(dp)
    ranks, cols = plan["ranks"], plan["cols"]
    covered = sorted(c for r in range(ranks)
                     for c in range(r * cols, (r + 1) * cols))
    assert covered == list(range(dp))
    assert plan["smem"] <= tfa.MAX_SHARED_BYTES
    assert plan["acc_registers"] + 32 + 16 <= 255
    assert 128 * plan["warpgroups"] * 255 <= 65536
    assert plan["rows"] == tfa.KERNEL_BLOCK_K == 64
    assert tfa.column_slices(dp, torch.bfloat16) == ranks
    src = (CSRC / "flash_attention.cu").read_text()
    cluster = re.search(rf"if \(D == {dp}\)\s*return launch_bwd_cluster"
                        rf"<{dp // 2}>", src)
    if dp <= 512:
        assert cluster
        assert plan["route"] == "cluster" and ranks == 2
        assert (plan["warpgroups"], cols) == (2, dp // 2)
        assert plan["score_passes"] == 1
        assert plan["acc_registers"] == 64 * cols // 128
        assert "static constexpr int kBars = 5;" in src
        assert "static constexpr uint32_t kStats = 2 * 2 * 64 *" in src
        assert ("1024 + 6 * (size_t)kOperand + 2 * kX + kStats + 8 * kBars"
                in src)
        assert plan["smem"] == (1024 + 6 * 64 * cols * 2 + 2 * 64 * 64 * 4
                                + 2 * 2 * 64 * 4 + 8 * 5)
    else:
        assert not cluster
        assert plan["route"] == "slices"
        assert (plan["warpgroups"], cols) == (1, tfa.WIDE_COLS)
        assert ranks == plan["score_passes"] == dp // 128
        assert "1024 + (size_t)8 * 64 * kWC * 2 + 2 * 2 * kBQ" in src
        assert plan["smem"] == 1024 + 8 * 64 * 128 * 2 + 2 * 2 * 64 * 4
    for bad in (256, 4096 + 128):
        with pytest.raises(ValueError):
            tfa.wide_bwd_plan(bad)


def _cluster_backward(q, k, v, o, lse, do, causal, scale):
    """The cluster backward's arithmetic (wide_bwd_plan "cluster") in
    plain fp32 PyTorch on (BH, S, D): for each pair of 64-key and
    64-query tiles each rank computes S^T and dP^T over its own
    columns only, both ranks add the two partials in rank order (rank
    0's, then rank 1's: the same bits on both, asserted), and each
    takes p and ds from the sums and accumulates its columns of dv, dk
    and dq. do is scaled by sm_scale, delta = sum(do * o) * sm_scale and
    dv divided by sm_scale at the end, as the kernels take them."""
    plan = tfa.wide_bwd_plan(q.shape[-1])
    rows, sq, sk = plan["rows"], q.shape[1], k.shape[1]
    cols = [slice(r * plan["cols"], (r + 1) * plan["cols"])
            for r in range(plan["ranks"])]
    dos = do * scale
    delta = (do * o).sum(-1) * scale
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    for k0 in range(0, sk, rows):
        for q0 in range(0, sq, rows):
            ki, qi = slice(k0, k0 + rows), slice(q0, q0 + rows)
            s_part = [k[:, ki, c] @ q[:, qi, c].transpose(1, 2)
                      for c in cols]
            dp_part = [v[:, ki, c] @ dos[:, qi, c].transpose(1, 2)
                       for c in cols]
            # rank 0 adds its own partial and then its partner's; rank 1
            # its partner's (rank 0's) and then its own
            by_rank = [(s_part[0] + s_part[1], dp_part[0] + dp_part[1]),
                       (s_part[0] + s_part[1], dp_part[0] + dp_part[1])]
            # IEEE addition commutes: whichever operand a rank holds in
            # its registers, the two sums have the same bits
            assert torch.equal(s_part[1] + s_part[0], by_rank[1][0])
            assert torch.equal(dp_part[1] + dp_part[0], by_rank[1][1])
            s_t, dp_t = by_rank[0]
            p = torch.exp(s_t * scale - lse[:, None, qi])
            if causal:
                key = torch.arange(k0, k0 + s_t.shape[1])[:, None]
                query = torch.arange(q0, q0 + s_t.shape[2])[None, :]
                p = torch.where(key <= query + sk - sq, p, 0.0)
            ds = p * (dp_t - delta[:, None, qi])
            for c in cols:
                dv[:, ki, c] += p @ dos[:, qi, c]
                dk[:, ki, c] += ds @ q[:, qi, c]
                dq[:, qi, c] += ds.transpose(1, 2) @ k[:, ki, c]
    return dq, dk, dv / scale


@pytest.mark.parametrize("bh,sq,sk,d,causal",
                         [(2, 40, 24, 384, True), (1, 70, 90, 512, True)],
                         ids=["d384_masked_rows", "d512_two_tiles"])
def test_flash_cluster_backward_rank_order_matches_pallas(bh, sq, sk, d,
                                                          causal):
    """dq, dk and dv from each rank's partial S and dP, summed in rank
    order (`_cluster_backward`), against the JAX package's fused Pallas
    backward (interpret mode) fed the Pallas forward's (o, lse), at D =
    384 (fully masked rows: Sq > Sk) and D = 512 (two tiles of keys and
    of queries, ragged), on seeded numpy inputs as in
    tests/test_torch_head_dims.py."""
    rng = np.random.RandomState(0)
    q, k, v, do = (rng.randn(bh, n, d).astype(np.float32)
                   for n in (sq, sk, sk, sq))
    scale = 1.0 / math.sqrt(d)

    @jax.jit
    def fwd_bwd(q, k, v, do):
        o, lse = jfa._flash_fwd_pallas(q, k, v, causal, scale, 16, 16,
                                       interpret=True)
        return o, lse, jfa._flash_bwd_pallas_fused(
            q, k, v, o, lse, do, causal, scale, 16, 16, interpret=True)

    jo, jl, jg = fwd_bwd(*map(jnp.asarray, (q, k, v, do)))
    got = _cluster_backward(*(torch.from_numpy(np.array(a)) for a in
                              (q, k, v, jo, jl, do)), causal, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, jg):
        b = np.asarray(b, np.float64)
        err = np.abs(a.numpy().astype(np.float64) - b).max()
        assert err <= FLASH_GRAD_RTOL * np.abs(b).max(), (name, err)


def test_kernel_study_wide_parts_need_the_old_sources():
    from bigdl_tpu_torch.ops import kernel_study as ks

    assert {"k1_wide", "flash_bf16_wide", "flash_bf16_wide_bwd"} \
        <= set(ks.PARTS)
    for part in ("k1_wide", "flash_bf16_wide", "flash_bf16_wide_bwd"):
        with pytest.raises(SystemExit):
            ks.main(["--parts", part])
