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

`launches` counts kernel launches (a plain int, incremented only where
the kernel is launched), so a run can show that its decode path went
through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops.kv_cache import paged_attention

IMPLS = ("cuda", "torch")
# shared memory one CTA may use on Hopper (227 KB, opt-in above 48 KB)
MAX_SHARED_BYTES = 232448
# csrc/paged_decode.cu: threads a CTA, ring stages, the portable cluster
# size (kThreads, kStages, kMaxSplits)
_THREADS, _STAGES, MAX_SPLITS = 128, 4, 8
# a (row, head) is split only into ranges of at least SPLIT_MIN_KEYS
# keys, each a multiple of SPLIT_ALIGN keys (a 16-key page at the
# engine's block size)
SPLIT_MIN_KEYS, SPLIT_ALIGN = 64, 16

launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_decode")
    fn = lib.bigdl_paged_decode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
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


def _stage_keys(head_dim: int, itemsize: int) -> int:
    """Keys a ring stage holds (csrc/paged_decode.cu's Geo kSK): a key
    row is head_dim * itemsize / 16 chunks of 16 bytes, read by the
    largest power of two <= 32 threads dividing that count; each group
    of threads takes 2 keys a stage (1 when a thread reads > 2 chunks)."""
    chunks = head_dim * itemsize // 16
    group = next(g for g in (32, 16, 8, 4) if chunks % g == 0)
    return _THREADS // group * (2 if chunks // group <= 2 else 1)


def shared_bytes(num_blocks: int, block_size: int, head_dim: int,
                 itemsize: int) -> int:
    """Dynamic shared memory one CTA of the kernel takes: its result
    (m, l and D floats, padded to 16 bytes), the ring of K and V stages
    in the pools' dtype, and its slice of the table row."""
    _, span = split_plan(num_blocks, block_size)
    return (4 * (head_dim + 4)
            + itemsize * _STAGES * 2 * _stage_keys(head_dim, itemsize)
            * head_dim
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
    if d % 32 or d > 256:
        raise ValueError(f"paged_decode impl='cuda' needs head_dim a "
                         f"multiple of 32 and <= 256, got {d}")
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
    splits, span = split_plan(table.shape[1], k_pool.shape[2])
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.bigdl_paged_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            table.data_ptr(), pos.data_ptr(), out.data_ptr(), b, h,
            table.shape[1], k_pool.shape[2], d, splits, span,
            float(sm_scale), int(k_pool.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(
            "paged_decode kernel launch failed: "
            f"{lib.bigdl_cuda_error_string(err).decode()} (cudaError "
            f"{err})")
    launches += 1
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
