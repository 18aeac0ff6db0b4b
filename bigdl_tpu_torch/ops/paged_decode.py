"""Paged-attention decode: the CUDA kernel and its plain version.

Ports bigdl_tpu/ops/paged_decode.py. There the kernel is the Pallas
`_pd_kernel`, whose grid streams table-routed pool blocks through VMEM;
here it is the hand-written CUDA kernel `csrc/paged_decode.cu`: each
(row, head) gets a thread-block cluster of `split_plan(...)[0]` CTAs,
each streaming its own contiguous range of keys through shared memory
with an online softmax, and rank 0 combines the ranks' partial results
through distributed shared memory. The plain version is
`ops/kv_cache.paged_attention`, gather-then-attend.

`impl`: None picks `"cuda"` for CUDA tensors and `"torch"` for CPU
tensors; `"torch"` runs the plain version on whatever device the
tensors are on; `"cuda"` launches the kernel and raises on CPU tensors
and on any failure to build or launch — there is no fallback.

The Pallas kernel's dup-batch trick (a workaround for XLA on the CPU)
and its tile knobs have no counterpart: the CUDA kernel's split plan
depends on the table extent alone, so its bits do not depend on the
batch extent or the clocks, and it has no tiles to choose.

Head dims: the kernel takes any D >= 1. It is instantiated at the
tiers HEAD_DIMS and a call runs at the least tier that holds D
(`kernel_head_dim`), with D itself passed at run time: the pools are
read where they lie, at their own row stride, and never padded or
copied. Rows of whole 16-byte chunks stream as 16-byte copies; any
other row (a bf16 row of D = 20 is 40 bytes) element by element
(`vector_rows`). Above the largest tier a row-split kernel runs, in one
launch too: the keys split over a cluster as the tiers split them
(`wide_plan`, from the table extent, the head dim and the dtype alone),
each row over a whole CTA's threads, K and V through a ring of
asynchronous copies 16, 8 bytes or an element wide (`wide_copy_bytes`),
one online-softmax pass, the ranks combined through distributed shared
memory; up to WIDE_MAX_HEAD_DIM.

`launches` counts kernel launches (a plain int, incremented only where
the kernel is launched), so a run can show that its decode path went
through the kernel; `launches_by_head_dim` splits the same count by the
head dim launched.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops.kv_cache import paged_attention

IMPLS = ("cuda", "torch")
# the tiers csrc/paged_decode.cu instantiates: 8, 16, the multiples of
# 32 to 256, then 384, 512, 768 and 1024; a head dim runs at the least
# tier that holds it, above the largest on the row-split kernel
HEAD_DIMS = (8, 16) + tuple(range(32, 257, 32)) + (384, 512, 768, 1024)
# shared memory one CTA may use on Hopper (227 KB, opt-in above 48 KB)
MAX_SHARED_BYTES = 232448
# csrc/paged_decode.cu: threads a CTA, ring stages, the portable cluster
# size (kThreads, kStages, kMaxSplits)
_THREADS, _STAGES, MAX_SPLITS = 128, 4, 8
# a (row, head) is split only into ranges of at least SPLIT_MIN_KEYS
# keys, each a multiple of SPLIT_ALIGN keys (a 16-key page at the
# engine's block size)
SPLIT_MIN_KEYS, SPLIT_ALIGN = 64, 16
# above the tiers (csrc/paged_decode.cu "D > 1024"): threads a CTA, ring
# stages, the most 16-byte chunks of a row a thread holds, and the K and
# V bytes a rank takes at least
_WIDE_THREADS, _WIDE_STAGES, _WIDE_MAX_CHUNKS = 256, 3, 8
WIDE_MIN_BYTES = 32 * 1024
# the widest rows: 8 chunks of 16 bytes for each of 256 threads
WIDE_MAX_HEAD_DIM = {4: 8192, 2: 16384}   # by the pools' itemsize

launches = 0
launches_by_head_dim: dict = {}


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_decode")
    fn = lib.bigdl_paged_decode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        wide = lib.bigdl_paged_decode_wide
        wide.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        wide.restype = ctypes.c_int
        lib.bigdl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.bigdl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def split_plan(num_blocks: int, block_size: int) -> tuple:
    """(splits, span): the CTAs a (row, head) takes, one cluster, and the
    keys each takes — CTA `rank` the range [rank * span, (rank + 1) *
    span) of the table extent S = num_blocks * block_size. A function of
    S alone, so a row's bits depend neither on B nor on the clocks: up to
    MAX_SPLITS ranges of at least SPLIT_MIN_KEYS keys, span a multiple of
    SPLIT_ALIGN, the last range non-empty."""
    seq = num_blocks * block_size
    splits = max(1, min(MAX_SPLITS, -(-seq // SPLIT_MIN_KEYS)))
    span = -(-seq // splits)
    span = -(-span // SPLIT_ALIGN) * SPLIT_ALIGN
    return -(-seq // span), span


def wide_plan(num_blocks: int, block_size: int, head_dim: int,
              itemsize: int) -> dict:
    """The row-split kernel's layout above the tiers (csrc/paged_decode.cu
    "D > 1024"), a function of the table extent S = num_blocks *
    block_size, the head dim and the pools' itemsize alone, so a row's
    bits depend neither on B nor on the clocks:

    * `splits` CTAs a (row, head), one cluster (<= MAX_SPLITS), each the
      keys [rank * span, (rank + 1) * span) and at least WIDE_MIN_BYTES
      of K and V rows (rows of 4-9 KB at D = 1100 split finer than
      SPLIT_MIN_KEYS), the last range non-empty;
    * `chunks`: 16-byte chunks of a (16-byte padded) row a thread holds,
      a power of two <= 8, so q and the weighted V row stay in
      registers;
    * `stage_keys`: keys a ring stage holds (8 / chunks: the ring of
      3 stages of K and V rows stays <= 192 KB);
    * `smem`: the CTA's dynamic shared memory (ring, partial dots, table
      slice).

    Raises above WIDE_MAX_HEAD_DIM[itemsize]."""
    top = WIDE_MAX_HEAD_DIM[itemsize]
    if not HEAD_DIMS[-1] < head_dim <= top:
        raise ValueError(f"paged_decode's row-split kernel takes head dims "
                         f"{HEAD_DIMS[-1] + 1}..{top} at itemsize "
                         f"{itemsize}, got {head_dim}")
    seq = num_blocks * block_size
    rowb = -(-head_dim * itemsize // 16) * 16
    least = max(1, -(-WIDE_MIN_BYTES // (2 * head_dim * itemsize)))
    splits = max(1, min(MAX_SPLITS, seq // least))
    span = -(-seq // splits)
    chunks = 1
    while chunks * _WIDE_THREADS * 16 < rowb:
        chunks *= 2
    stage_keys = _WIDE_MAX_CHUNKS // chunks
    return {"splits": -(-seq // span), "span": span, "chunks": chunks,
            "stage_keys": stage_keys,
            "smem": (_WIDE_STAGES * 2 * stage_keys * rowb
                     + 4 * (_WIDE_THREADS // 32) * stage_keys
                     + 4 * (-(-span // block_size) + 1))}


def wide_copy_bytes(head_dim: int, itemsize: int, *pools: torch.Tensor
                    ) -> int:
    """The row-split kernel's copy width in bytes: 16 for rows of whole
    16-byte chunks, 8 for rows of whole 8-byte pieces (a bf16 row of
    D = 1100 is 2200 bytes: every other row starts 8 bytes off a 16-byte
    boundary), else the element (4 fp32, 2 bf16: an odd bf16 D) — each
    only where every pool starts on that many bytes."""
    for width in (16, 8):
        if head_dim * itemsize % width == 0 \
                and all(t.data_ptr() % width == 0 for t in pools):
            return width
    return itemsize


def kernel_head_dim(head_dim: int) -> int:
    """The tier a head dim runs at: the least entry of HEAD_DIMS that
    holds it; above the largest the head dim itself (the row-split
    kernel). Raises below 1."""
    if head_dim < 1:
        raise ValueError(f"paged_decode takes head_dim >= 1, got "
                         f"{head_dim}")
    return next((t for t in HEAD_DIMS if head_dim <= t), head_dim)


def vector_rows(head_dim: int, itemsize: int, *pools: torch.Tensor
                ) -> bool:
    """Whether the pools' rows stream as 16-byte copies in the tiers: a
    row of head_dim elements is whole 16-byte chunks and every pool
    starts on a 16-byte boundary (`wide_copy_bytes` 16). Otherwise the
    kernel copies element by element."""
    return wide_copy_bytes(head_dim, itemsize, *pools) == 16


def _stage_keys(tier: int, itemsize: int) -> int:
    """Keys a ring stage holds (csrc/paged_decode.cu's Geo kSK) at a
    tier: a key row is tier * itemsize / 16 chunks of 16 bytes, read by
    the largest power of two <= 32 threads dividing that count; each
    group of threads takes 2 keys a stage (1 when a thread reads > 2
    chunks)."""
    chunks = tier * itemsize // 16
    group = next(g for g in (32, 16, 8, 4, 2, 1) if chunks % g == 0)
    return _THREADS // group * (2 if chunks // group <= 2 else 1)


def shared_bytes(num_blocks: int, block_size: int, head_dim: int,
                 itemsize: int) -> int:
    """Dynamic shared memory one CTA of the kernel takes at the tier of
    `head_dim`: its result (m, l and a tier of floats), the ring of K
    and V stages in the pools' dtype, laid out at the tier, and its
    slice of the table row."""
    _, span = split_plan(num_blocks, block_size)
    tier = kernel_head_dim(head_dim)
    return (4 * (tier + 4)
            + itemsize * _STAGES * 2 * _stage_keys(tier, itemsize) * tier
            + 4 * (-(-span // block_size) + 1))


def _check(q, k_pool, v_pool, table, pos) -> None:
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError("paged_decode expects q (B, H, 1, D) and pools "
                         "(N, H, bs, D)")
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "table": table, "pos": pos}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"paged_decode impl='cuda': {name} must be "
                             f"a CUDA tensor on {q.device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode impl='cuda': {name} must be "
                             "contiguous")
    if q.dtype != torch.float32:
        raise ValueError(f"paged_decode impl='cuda': q must be float32, "
                         f"got {q.dtype}")
    if k_pool.dtype not in (torch.float32, torch.bfloat16) \
            or v_pool.dtype != k_pool.dtype:
        raise ValueError("paged_decode impl='cuda': pools must both be "
                         "float32 or both bfloat16, got "
                         f"{k_pool.dtype}/{v_pool.dtype}")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("paged_decode impl='cuda': table and pos must "
                         f"be int32, got {table.dtype}/{pos.dtype}")
    b, h, _, d = q.shape
    n, hp, bs, dp = k_pool.shape
    if v_pool.shape != k_pool.shape or (hp, dp) != (h, d) \
            or table.dim() != 2 or table.shape[0] != b \
            or pos.shape != (b,):
        raise ValueError(
            f"paged_decode shapes disagree: q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, table "
            f"{tuple(table.shape)}, pos {tuple(pos.shape)}")
    if kernel_head_dim(d) > HEAD_DIMS[-1]:
        smem = wide_plan(table.shape[1], bs, d,
                         k_pool.element_size())["smem"]
    else:
        smem = shared_bytes(table.shape[1], bs, d, k_pool.element_size())
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"paged_decode impl='cuda': a table extent of "
                         f"{table.shape[1] * bs} keys needs {smem} bytes "
                         f"of shared memory (> {MAX_SHARED_BYTES})")


def _paged_decode_cuda(q, k_pool, v_pool, table, pos,
                       sm_scale: float) -> torch.Tensor:
    global launches
    _check(q, k_pool, v_pool, table, pos)
    b, h, _, d = q.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _lib()
    itemsize = k_pool.element_size()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kernel_head_dim(d) > HEAD_DIMS[-1]:
            plan = wide_plan(table.shape[1], k_pool.shape[2], d, itemsize)
            err = lib.bigdl_paged_decode_wide(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                table.data_ptr(), pos.data_ptr(), out.data_ptr(), b, h,
                table.shape[1], k_pool.shape[2], d, plan["splits"],
                plan["span"], plan["chunks"],
                wide_copy_bytes(d, itemsize, k_pool, v_pool),
                float(sm_scale), int(k_pool.dtype == torch.bfloat16),
                stream)
        else:
            splits, span = split_plan(table.shape[1], k_pool.shape[2])
            err = lib.bigdl_paged_decode(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                table.data_ptr(), pos.data_ptr(), out.data_ptr(), b, h,
                table.shape[1], k_pool.shape[2], kernel_head_dim(d), d,
                int(vector_rows(d, k_pool.element_size(), k_pool, v_pool)),
                splits, span, float(sm_scale),
                int(k_pool.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(
            "paged_decode kernel launch failed: "
            f"{lib.bigdl_cuda_error_string(err).decode()} (cudaError "
            f"{err})")
    launches += 1
    launches_by_head_dim[d] = launches_by_head_dim.get(d, 0) + 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, table: torch.Tensor,
                           pos: torch.Tensor,
                           sm_scale: Optional[float] = None,
                           impl: Optional[str] = None) -> torch.Tensor:
    """Q=1 paged attention: q (B, H, 1, D), pools (N, H, bs, D), table
    (B, nb) int32, pos (B,) int32 row clocks → (B, H, 1, D) in q's
    dtype. Same shapes and conventions as the JAX package's
    `paged_decode_attention`; `impl` as in the module docstring."""
    if q.shape[-2] != 1:
        raise ValueError(f"paged_decode_attention decodes one row, "
                         f"got q length {q.shape[-2]}")
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if impl is None:
        impl = "cuda" if q.is_cuda else "torch"
    if impl == "torch":
        return paged_attention(q, k_pool, v_pool, table, pos, sm_scale)
    if impl != "cuda":
        raise ValueError(f"impl {impl!r}: expected one of {IMPLS}")
    return _paged_decode_cuda(q, k_pool, v_pool, table, pos, sm_scale)
