"""Flash attention: the CUDA kernels and their plain versions.

Ports bigdl_tpu/ops/flash_attention.py. There the forward is the Pallas
kernel `_fa_kernel` and the backward either the one-pass
`_fa_bwd_fused_kernel` or the pair `_fa_bwd_dq_kernel` +
`_fa_bwd_dkv_kernel`; here all of them are the hand-written CUDA
kernels of `csrc/flash_attention.cu`: one forward launch, and a
backward of two launches (dk/dv over kv tiles, dq over q tiles) that
computes what the fused kernel computes.

The JAX package routes its backward between the fused and the split
kernels by a TPU-VMEM bound on the fused kernel's full-sequence dq
scratch (`resolve_bwd_form`). On the card no state persists across
CTAs, so one design serves both routes and the port has no router.
Nor do the Pallas tile arguments (`block_q`, `block_k`, `bwd_block_k`,
`bwd_tiles`) and the `BIGDL_FLASH_*_TILES` environment knobs carry
over: they tune TPU grid cells and do not bind a Hopper design, so the
port's signatures leave them out. The blockwise-XLA `impl="xla"` path
has no counterpart either; `impl="torch"` is the plain version.

Conventions, the same in both packages: q (B, H, Sq, D) or (BH, Sq, D),
k and v with Sk rows; bottom-right causal alignment (key j visible to
query i iff j <= i + Sk - Sq); masked scores are the finite -1e30 with
fp32 scores, masked probabilities exactly 0, so a fully masked row
gives zero output and LSE -1e30; the LSE returned is the natural-log
LSE.

The kernels take fp32 or bf16. bf16 runs its products on the tensor
cores (wgmma, operands streamed into swizzled shared memory by
cp.async); fp32 runs on the SIMT cores, since the tensor cores would
round its operands to TF32. Both keep the conventions above and tiles
of KERNEL_BLOCK_K keys, whose width decides where the bf16 forward
rounds p. The bf16 kernels' asynchronous copies read 16-byte rows, so
`_check` refuses a bf16 operand whose data does not start on a 16-byte
boundary.

The kernels take any head dim. They are instantiated at HEAD_DIMS; a
D up to 256 is zero-padded to the next instantiation, a D above 256 to
the next multiple of WIDE_COLS, and the results sliced back
(`pad_head_dim` / `unpad_head_dim`), as the JAX wrapper pads D to a
multiple of 128 before its kernels: zero columns add exact zeros to
every score and leave the padded output and gradient columns zero, and
`sm_scale` stays that of the unpadded D. Above 256 the column-split
kernels run (`column_slices`): each CTA owns WIDE_COLS columns of the
output (or of dq, dk and dv) and computes the scores over the full D,
streamed in WIDE_COLS-column chunks, so no thread holds more than one
slice's accumulator. Every slice writes its own lse row, the same bits
(`flash_fwd_cuda(return_lse_slices=True)` returns them all).

`impl`, in `flash_attention` and `flash_attention_with_lse` alike:
None picks `"cuda"` for CUDA tensors and `"torch"` for CPU tensors;
`"torch"` runs the plain version on whatever device the tensors are
on; `"cuda"` launches the kernels and raises on CPU tensors and on any
failure to build or launch — there is no fallback.

`flash_forward_tiled` / `flash_backward_tiled` are the kernels'
arithmetic, tile by tile and rounding where the kernels round, in plain
PyTorch: the oracles that hold the bf16 kernels to their roundings.

`fwd_launches` / `bwd_launches` count kernel launches (plain ints,
incremented only where a kernel is launched; a backward makes
`BWD_LAUNCHES` of them), so a run can show that its attention went
through the kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from bigdl_tpu_torch.ops import _build

IMPLS = ("cuda", "torch")
NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)  # csrc/flash_attention.cu instantiations
WIDE_COLS = 128                # columns a slice above 256 (csrc kWC)
BWD_LAUNCHES = 2               # dk/dv kernel, then dq kernel
MAX_BH = 65535                 # grid.y of every launch
KERNEL_BLOCK_K = 64            # keys per tile of the kernels (kBK)
REF_BLOCK_K = 128              # keys per block of the plain backward

fwd_launches = 0
bwd_launches = 0


# ------------------------------------------------------------ plain
def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False,
                        sm_scale: Optional[float] = None,
                        return_lse: bool = False, dropout: float = 0.0,
                        dropout_generator: Optional[torch.Generator] = None):
    """Plain softmax attention over (..., S, D); materializes S x S.

    The oracle of the kernels and the `impl="torch"` forward. Scores
    are fp32 dots of the operands (the Pallas kernel's
    `preferred_element_type=f32`; for fp32 inputs this is exactly the
    JAX reference), probabilities are rounded to v's dtype before the
    P.V product, which accumulates in fp32 and rounds once to q's dtype.

    `dropout` > 0 applies inverted dropout to the normalized
    probabilities, each kept with probability 1 - dropout by a draw
    from `dropout_generator` (on the operands' device) — the one path
    that needs the probabilities materialized (`nn.MultiHeadAttention`
    in training). The mask is torch's stream, not threefry's, so the
    JAX reference agrees at dropout 0 and in expectation."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        q_len, k_len = s.shape[-2], s.shape[-1]
        row = torch.arange(q_len, device=s.device)[:, None]
        col = torch.arange(k_len, device=s.device)[None, :]
        s = torch.where(col <= row + (k_len - q_len), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    # fully masked rows (causal with Sq > Sk) emit zeros
    probs = torch.where(m > NEG_INF / 2, p / l, 0.0)
    if dropout > 0.0:
        if dropout_generator is None:
            raise ValueError("attention dropout needs dropout_generator")
        keep = 1.0 - dropout
        mask = torch.empty(probs.shape, device=probs.device).bernoulli_(
            keep, generator=dropout_generator).bool()
        probs = torch.where(mask, probs, 0.0) / keep
    out = torch.matmul(probs.to(v.dtype).float(), v.float()).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        lse: torch.Tensor, do: torch.Tensor, causal: bool = False,
        sm_scale: Optional[float] = None,
        dlse: Optional[torch.Tensor] = None,
        delta: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain flash backward on (BH, S, D): (dq, dk, dv) from the
    forward's output and natural-log LSE, sweeping blocks of
    REF_BLOCK_K keys and recomputing the probabilities from the LSE —
    nothing S x S is held. Written out like the JAX package's
    `_flash_bwd_blockwise`: fp32 throughout, gradients rounded to the
    input dtypes at the end. `dlse`, the gradient of the LSE output
    (None: zero), enters as delta - dlse, since d lse_i / d s_ij is
    p_ij. `delta`, if given, is sum(do * o) already taken (fp32, before
    dlse), as the kernels' wrapper takes it over the unpadded head dim
    before padding (`pad_head_dim`). The oracle of the backward kernels
    and the `impl="torch"` backward."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    seq_q, seq_k = q.shape[1], k.shape[1]
    q32, do32 = q.float(), do.float()
    if delta is None:
        delta = (do32 * o.float()).sum(dim=-1)              # (BH, Sq)
    if dlse is not None:
        delta = delta - dlse.float()
    dq = torch.zeros_like(q32)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    row = torch.arange(seq_q, device=q.device)[:, None]
    for j0 in range(0, seq_k, REF_BLOCK_K):
        kb = k[:, j0:j0 + REF_BLOCK_K].float()
        vb = v[:, j0:j0 + REF_BLOCK_K].float()
        s = torch.matmul(q32, kb.transpose(1, 2)) * sm_scale
        p = torch.exp(s - lse[..., None])
        if causal:
            col = j0 + torch.arange(kb.shape[1], device=q.device)[None, :]
            p = torch.where(col <= row + (seq_k - seq_q), p, 0.0)
        dv[:, j0:j0 + REF_BLOCK_K] = torch.matmul(p.transpose(1, 2), do32)
        dp = torch.matmul(do32, vb.transpose(1, 2))
        ds = p * (dp - delta[..., None]) * sm_scale
        dq = dq + torch.matmul(ds, kb)
        dk[:, j0:j0 + REF_BLOCK_K] = torch.matmul(ds.transpose(1, 2), q32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------- the kernels' rounding
def _visible(j0: int, width: int, seq_q: int, seq_k: int,
             device) -> torch.Tensor:
    """(Sq, width) causal mask of the keys [j0, j0 + width)."""
    row = torch.arange(seq_q, device=device)[:, None]
    col = j0 + torch.arange(width, device=device)[None, :]
    return col <= row + (seq_k - seq_q)


def flash_forward_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False,
                        sm_scale: Optional[float] = None,
                        round_operands: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's arithmetic in plain PyTorch, on (BH, S, D):
    an online softmax over tiles of KERNEL_BLOCK_K keys with the running
    max, sum and accumulator in fp32, each tile's probabilities (taken
    against the running max) rounded to v's dtype before the P.V
    product when `round_operands`. Returns fp32 (out, lse), out before
    its final rounding to q's dtype.

    For fp32 inputs this is the plain forward summed in another order.
    For bf16 inputs it holds the kernel to its rounding to within fp32
    summation order — `attention_reference` rounds the normalized
    probabilities instead, a difference of about one bf16 ulp — and
    with round_operands=False it is the control that shows a check can
    tell the rounding from its absence."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    bh, seq_q, d = q.shape
    seq_k = k.shape[1]
    q32 = q.float()
    m = torch.full((bh, seq_q, 1), NEG_INF, device=q.device)
    l = torch.zeros((bh, seq_q, 1), device=q.device)
    acc = torch.zeros((bh, seq_q, d), device=q.device)
    for j0 in range(0, seq_k, KERNEL_BLOCK_K):
        kb = k[:, j0:j0 + KERNEL_BLOCK_K].float()
        vb = v[:, j0:j0 + KERNEL_BLOCK_K].float()
        s = torch.matmul(q32, kb.transpose(1, 2)) * sm_scale
        if causal:
            vis = _visible(j0, kb.shape[1], seq_q, seq_k, q.device)
            s = torch.where(vis, s, NEG_INF)
        mn = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - mn)
        p = torch.exp(s - mn)
        if causal:
            p = torch.where(vis, p, 0.0)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        if round_operands:
            p = p.to(v.dtype).float()
        acc = acc * alpha + torch.matmul(p, vb)
        m = mn
    empty = l == 0
    safe = torch.where(empty, 1.0, l)
    lse = torch.where(empty, NEG_INF, m + torch.log(safe))
    return acc / safe, lse[..., 0]


def flash_backward_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         o: torch.Tensor, lse: torch.Tensor,
                         do: torch.Tensor, causal: bool = False,
                         sm_scale: Optional[float] = None,
                         round_operands: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' arithmetic in plain PyTorch, on
    (BH, S, D): do pre-scaled by sm_scale and rounded to q's dtype,
    delta = sum(do * o) * sm_scale, p = exp(s - lse), ds = p * (dp -
    delta) in fp32, and p and ds rounded to q's dtype at their dots
    (P^T.dO, dS^T.Q, dS.K) when `round_operands`; dv divided by
    sm_scale at the end; sm_scale == 0 leaves do unscaled and ds zero.
    Returns fp32 (dq, dk, dv) before their final rounding. The
    backward's counterpart of `flash_forward_tiled`, control
    included."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    zero = sm_scale == 0.0
    seq_q, seq_k = q.shape[1], k.shape[1]

    def operand(t):
        return t.to(q.dtype).float() if round_operands else t

    do_n = do.to(q.dtype).float()            # the wrapper's cast
    delta = ((do_n * o.float()).sum(dim=-1) * sm_scale)[..., None]
    dos = operand(do_n * (1.0 if zero else sm_scale))
    q32 = q.float()
    dq = torch.zeros_like(q32)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    for j0 in range(0, seq_k, KERNEL_BLOCK_K):
        kb = k[:, j0:j0 + KERNEL_BLOCK_K].float()
        vb = v[:, j0:j0 + KERNEL_BLOCK_K].float()
        s = torch.matmul(q32, kb.transpose(1, 2)) * sm_scale
        p = torch.exp(s - lse[..., None])
        if causal:
            p = torch.where(_visible(j0, kb.shape[1], seq_q, seq_k,
                                     q.device), p, 0.0)
        dp = torch.matmul(dos, vb.transpose(1, 2))
        ds = torch.zeros_like(p) if zero else operand(p * (dp - delta))
        dv[:, j0:j0 + KERNEL_BLOCK_K] = torch.matmul(
            operand(p).transpose(1, 2), dos) * (1.0 if zero
                                                 else 1.0 / sm_scale)
        dk[:, j0:j0 + KERNEL_BLOCK_K] = torch.matmul(ds.transpose(1, 2),
                                                     q32)
        dq = dq + torch.matmul(ds, kb)
    return dq, dk, dv


# ------------------------------------------------- head-dim padding
def kernel_head_dim(d: int) -> int:
    """The head dim `d` runs at: the least entry of HEAD_DIMS that holds
    it, or above the largest the next multiple of WIDE_COLS."""
    if d < 1:
        raise ValueError(f"flash_attention takes head_dim >= 1, got {d}")
    for dp in HEAD_DIMS:
        if d <= dp:
            return dp
    return -(-d // WIDE_COLS) * WIDE_COLS


def column_slices(dp: int) -> int:
    """CTAs a (q tile, batch-head) takes at the kernel head dim `dp`
    (`kernel_head_dim`): 1 at the instantiations of HEAD_DIMS, else one
    a WIDE_COLS-column slice of the output, the column-split kernels."""
    if dp in HEAD_DIMS:
        return 1
    if dp <= HEAD_DIMS[-1] or dp % WIDE_COLS:
        raise ValueError(f"flash_attention kernels run at head dims "
                         f"{HEAD_DIMS} or multiples of {WIDE_COLS} above "
                         f"{HEAD_DIMS[-1]}, got {dp}")
    return dp // WIDE_COLS


def pad_head_dim(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The tensors zero-padded on their last axis to the kernels' head
    dim (`kernel_head_dim`); a tensor already there passes through.
    Zero columns add exact zeros to every q.k score and give zero
    output, dq, dk and dv columns."""
    dp = kernel_head_dim(tensors[0].shape[-1])
    return tuple(t if t.shape[-1] == dp
                 else torch.nn.functional.pad(t, (0, dp - t.shape[-1]))
                 for t in tensors)


def unpad_head_dim(d: int, *tensors: torch.Tensor
                   ) -> Tuple[torch.Tensor, ...]:
    """The first `d` columns of each tensor (the inverse of
    `pad_head_dim` on the kernels' results)."""
    return tuple(t if t.shape[-1] == d else t[..., :d].contiguous()
                 for t in tensors)


# ------------------------------------------------------------- CUDA
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.bigdl_flash_fwd.argtypes is None:
        lib.bigdl_flash_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.bigdl_flash_fwd.restype = ctypes.c_int
        lib.bigdl_flash_bwd.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
            + [ctypes.c_float] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.bigdl_flash_bwd.restype = ctypes.c_int
        lib.bigdl_flash_error_string.argtypes = [ctypes.c_int]
        lib.bigdl_flash_error_string.restype = ctypes.c_char_p
    return lib


def _check(**tensors: torch.Tensor) -> None:
    """Devices, dtypes, alignment and shapes the kernels take: (BH, S,
    D), one CUDA device, fp32 or bf16 throughout, bf16 data starting on
    a 16-byte boundary, D in HEAD_DIMS or a multiple of WIDE_COLS above
    them (the wrappers pad to it)."""
    q = tensors["q"]
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention impl='cuda': {name} must be "
                             f"a CUDA tensor on {q.device}, got {t.device}")
        if t.dim() != 3:
            raise ValueError(f"flash_attention impl='cuda': {name} must be "
                             f"(BH, S, D), got {tuple(t.shape)}")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"flash_attention impl='cuda': {name} must "
                             f"start on a 16-byte boundary (data_ptr "
                             f"{t.data_ptr():#x})")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("flash_attention impl='cuda' takes float32 or "
                         f"bfloat16, got {q.dtype}")
    for name in ("k", "v", "do"):
        if name in tensors and tensors[name].dtype != q.dtype:
            raise ValueError(f"flash_attention impl='cuda': {name} is "
                             f"{tensors[name].dtype}, q is {q.dtype}")
    bh, seq_q, d = q.shape
    k, v = tensors["k"], tensors["v"]
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"flash_attention shapes disagree: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    column_slices(d)
    if not 1 <= bh <= MAX_BH or seq_q < 1 or k.shape[1] < 1:
        raise ValueError(f"flash_attention impl='cuda': batch*heads "
                         f"{bh} must lie in [1, {MAX_BH}] and both "
                         f"sequences be non-empty")


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"flash_attention {what} kernel launch failed: "
            f"{lib.bigdl_flash_error_string(err).decode()} (cudaError "
            f"{err})")


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, sm_scale: float,
                   return_lse_slices: bool = False):
    """(out, lse) through the forward kernel, on (BH, S, D). The
    operands are made contiguous first (a copy for the model's
    head-transposed views); any other D is padded to the kernels' head
    dim and `out` sliced back (`pad_head_dim`). With
    `return_lse_slices`, also the lse rows of every column slice
    (`column_slices`, (slices, BH, S)): the first is `lse`, and the
    kernels compute them all alike."""
    global fwd_launches
    d_in = q.shape[-1]
    q, k, v = pad_head_dim(q.contiguous(), k.contiguous(), v.contiguous())
    _check(q=q, k=k, v=v)
    bh, seq_q, d = q.shape
    out = torch.empty_like(q)
    slices = torch.empty(column_slices(d), bh, seq_q, dtype=torch.float32,
                         device=q.device)
    lse = slices[0]
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.bigdl_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, seq_q, k.shape[1], d, float(sm_scale),
            int(causal), int(q.dtype == torch.bfloat16), stream)
    _raise_on(err, lib, "forward")
    fwd_launches += 1
    out = unpad_head_dim(d_in, out)[0]
    return (out, lse, slices) if return_lse_slices else (out, lse)


def flash_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   causal: bool, sm_scale: float,
                   dlse: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) through the two backward kernels, on (BH, S, D).
    delta = sum(do * o) * sm_scale is computed here in fp32, as the
    JAX package's `_bwd_prep` does, and handed to both kernels; the
    LSE's gradient `dlse`, if any, enters as (sum(do * o) - dlse) *
    sm_scale, which is all the kernels need to serve it. D is padded
    and the gradients sliced back, as in the forward; delta is taken
    over the unpadded columns."""
    global bwd_launches
    d_in = q.shape[-1]
    if o.shape != q.shape or lse.shape != q.shape[:2]:
        raise ValueError(f"flash_attention backward: o {tuple(o.shape)} "
                         f"/ lse {tuple(lse.shape)} do not match q "
                         f"{tuple(q.shape)}")
    do = do.to(q.dtype)
    delta = (do.float() * o.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    delta = (delta * sm_scale).contiguous()
    lse = lse.float().contiguous()
    q, k, v, do = pad_head_dim(q.contiguous(), k.contiguous(),
                               v.contiguous(), do.contiguous())
    _check(q=q, k=k, v=v, do=do)
    bh, seq_q, d = q.shape
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    zero = sm_scale == 0.0
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.bigdl_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), bh, seq_q, k.shape[1], d, float(sm_scale),
            1.0 if zero else float(sm_scale),
            1.0 if zero else 1.0 / sm_scale, int(zero), int(causal),
            int(q.dtype == torch.bfloat16), stream)
    _raise_on(err, lib, "backward")
    bwd_launches += BWD_LAUNCHES
    return unpad_head_dim(d_in, dq, dk, dv)


# ------------------------------------------------------- autograd
class _FlashAttention(torch.autograd.Function):
    """(out, lse), both differentiable. Forward saves (q, k, v, out,
    lse), as the JAX package's `_flash_core_fwd`; backward recomputes
    the probabilities from the LSE (kernels, or the plain blockwise
    backward under "torch")."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float, impl: str):
        if impl == "torch":
            out, lse = attention_reference(q, k, v, causal, sm_scale,
                                           return_lse=True)
        else:
            out, lse = flash_fwd_cuda(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.set_materialize_grads(False)      # an unused output gives None
        ctx.causal, ctx.sm_scale, ctx.impl = causal, sm_scale, impl
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(out)
        bwd = (flash_attention_backward_reference if ctx.impl == "torch"
               else flash_bwd_cuda)
        grads = bwd(q, k, v, out, lse, do, ctx.causal, ctx.sm_scale,
                    dlse=dlse)
        return (*grads, None, None, None)


def _resolve_impl(q: torch.Tensor, impl: Optional[str]) -> str:
    if impl is None:
        return "cuda" if q.is_cuda else "torch"
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r}: expected one of {IMPLS}")
    return impl


def _flatten(q, k, v):
    """(B, H, S, D) → (BH, S, D) views/copies; 3-D passes through."""
    if q.dim() == 4:
        b, h = q.shape[:2]
        return (q.reshape(b * h, *q.shape[2:]),
                k.reshape(b * h, *k.shape[2:]),
                v.reshape(b * h, *v.shape[2:])), (b, h)
    if q.dim() != 3:
        raise ValueError(f"flash_attention expects (B, H, S, D) or "
                         f"(BH, S, D), got {tuple(q.shape)}")
    return (q, k, v), None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Memory-efficient attention, differentiable in q, k and v.
    q (B, H, Sq, D) or (BH, Sq, D), k/v with Sk rows; returns q's shape
    and dtype. `impl` as in the module docstring: the kernels on CUDA
    tensors, the plain version (forward `attention_reference`,
    backward `flash_attention_backward_reference`) on CPU tensors."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    impl = _resolve_impl(q, impl)
    (q3, k3, v3), bh = _flatten(q, k, v)
    out, _ = _FlashAttention.apply(q3, k3, v3, bool(causal),
                                   float(sm_scale), impl)
    return out if bh is None else out.reshape(*bh, *out.shape[1:])


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             sm_scale: Optional[float] = None,
                             impl: Optional[str] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) for one KV chunk — the building block of callers that
    combine partial attention results themselves (ring attention).

    Differentiable in q, k and v through both outputs: the LSE's
    gradient folds into the backward's delta, so the same kernels (or
    plain versions) serve it. `impl` as in `flash_attention`. The JAX
    package defaults this function to its differentiable blockwise
    scan because its Mosaic forward kernel has no differentiation rule;
    here the kernels carry one, so the default is `flash_attention`'s."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    impl = _resolve_impl(q, impl)
    (q3, k3, v3), bh = _flatten(q, k, v)
    out, lse = _FlashAttention.apply(q3, k3, v3, bool(causal),
                                     float(sm_scale), impl)
    if bh is None:
        return out, lse
    return out.reshape(*bh, *out.shape[1:]), lse.reshape(*bh, -1)
