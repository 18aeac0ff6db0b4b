"""Persistent-RNN scans: the CUDA LSTM and GRU kernels and their plain
versions.

Ports bigdl_tpu/ops/fused_rnn.py. There the whole time loop runs in one
Pallas launch: `_lstm_fwd_kernel` / `_lstm_fwd_infer_kernel` and
`_lstm_bwd_kernel` for one LSTM direction (K6/K7),
`_bilstm_fwd_kernel` / `_bilstm_fwd_infer_kernel` and
`_bilstm_bwd_kernel` for both directions in one launch (K8/K9),
`_gru_fwd_kernel` / `_gru_fwd_infer_kernel` and `_gru_bwd_kernel` for
one GRU direction (K10/K11). Here they are the templated kernels of
`csrc/fused_rnn.cu`: for the LSTM one forward call (with or without
residuals: bf16 on the tensor cores with W in registers, fp32 SIMT over
a 4-CTA cluster a batch tile with W's columns in shared memory) and one
backward call, each running one or two directions per launch — the
reverse direction walks time backwards over true-time slots, so
nothing is flipped and both outputs come back in true time order; for
the GRU one forward (with or without residuals) and one backward, one
direction a launch.

Public functions keep the JAX signatures and the (N, T, .) layouts:
`lstm_scan(zx, w_hh)`, `bilstm_scan(zx_f, zx_b, w_f, w_b)` and
`gru_scan(zx_gates, zx_cand, w_g, w_c)`. zx is the hoisted input
projection including bias, (N, T, 4H); w_hh is (H, 4H), gates in the
order i, f, g, o. zx_gates (N, T, 2H) holds the z and r gates' hoisted
projections, zx_cand (N, T, H) the candidate's; w_g is (H, 2H), w_c
(H, H).

`impl`: None picks `"cuda"` for CUDA tensors and `"torch"` for CPU
tensors; `"torch"` is the plain version on whatever device; `"cuda"`
launches the kernels and raises on CPU tensors and on any failure to
build or launch — there is no fallback. The JAX package's `block_n`
sizes a TPU grid cell; here the kernels' batch tile is fixed at
`BLOCK_N` rows per CTA, and `block_n` is accepted for signature parity
only as None or `BLOCK_N`. There is no `impl="xla"` and no hidden-size
eligibility gate: above `MAX_HIDDEN` the kernels raise.

Gradients go through one `torch.autograd.Function` per call (kernels
or plain versions alike). Its forward runs the training variant, which
saves the residuals (LSTM: ys, c and the activated gates; GRU: ys, zr
and cand), only when autograd records and an input requires grad;
otherwise the inference variant writes ys alone, as the JAX
`custom_vjp` primal does. Both backwards return one fp32 dW a weight,
summed over the batch in a fixed order (the backward's second kernel,
a GEMM over all (t, row) pairs), and cast it to W's dtype.

The plain versions round where the kernels round. LSTM
(`lstm_forward_reference`, `lstm_backward_reference`): h and c carries
in fp32, h rounded to W's dtype before h . W, ys/c/gates stored in zx's
dtype, h_prev and c_prev read back from the stored sequences, dz in
fp32 stored as dzx in zx's dtype and rounded to W's dtype for both
products, dc in fp32. GRU (`gru_forward_reference`,
`gru_backward_reference`): the h carry in fp32, h and r * h rounded to
W's dtype before their products, zr/cand/ys stored in zg's dtype, h_prev
read back from the stored ys, dcand_pre and dzr in fp32, stored as
dzc/dzg in zg's dtype and rounded to W's dtype for the products, dh in
fp32. With `round_operands=False` they keep everything in fp32: the
control that shows a bf16 check can tell the roundings from their
absence.

`fwd_train_launches`, `fwd_infer_launches` and `bwd_launches` (LSTM),
`gru_fwd_train_launches`, `gru_fwd_infer_launches` and
`gru_bwd_launches` (GRU) count kernel launches (plain ints, incremented
only where a kernel launches).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from bigdl_tpu_torch.ops import _build

IMPLS = ("cuda", "torch")
MAX_HIDDEN = 512            # kMaxHidden of csrc/fused_rnn.cu (the JAX cap)
BLOCK_N = 4                 # kBlockN of csrc/fused_rnn.cu: rows per CTA
DW_PAIRS = 64               # kDwPairs: (t, row) pairs a dW stage holds

fwd_train_launches = 0
fwd_infer_launches = 0
bwd_launches = 0
gru_fwd_train_launches = 0
gru_fwd_infer_launches = 0
gru_bwd_launches = 0


def _resolve_impl(x: torch.Tensor, impl: Optional[str]) -> str:
    if impl is None:
        return "cuda" if x.is_cuda else "torch"
    if impl not in IMPLS:
        raise ValueError(f"fused_rnn impl {impl!r}: expected None or one "
                         f"of {IMPLS}")
    return impl


# ------------------------------------------------------------ plain
def _steps(n_t: int, reverse: bool):
    """(t, prev, live) in a direction's own time order."""
    for s in range(n_t):
        t = n_t - 1 - s if reverse else s
        prev = t + 1 if reverse else t - 1
        yield t, prev, 0 <= prev < n_t


def lstm_forward_reference(zx: torch.Tensor, w: torch.Tensor,
                           reverse: bool = False,
                           round_operands: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """One direction of the forward kernel in plain PyTorch: (ys, c,
    gates), (N, T, H), (N, T, H), (N, T, 4H) in zx's dtype (fp32 with
    round_operands=False). `reverse` runs time from T-1 down to 0 and
    keeps the true-time slots."""
    n, n_t, h4 = zx.shape
    hidden = h4 // 4
    out_dtype = zx.dtype if round_operands else torch.float32
    w32 = w.float()
    h = torch.zeros(n, hidden, device=zx.device)
    c = torch.zeros(n, hidden, device=zx.device)
    ys = torch.empty(n, n_t, hidden, dtype=out_dtype, device=zx.device)
    cs = torch.empty(n, n_t, hidden, dtype=out_dtype, device=zx.device)
    gs = torch.empty(n, n_t, h4, dtype=out_dtype, device=zx.device)
    for t, _, _ in _steps(n_t, reverse):
        op = h.to(w.dtype).float() if round_operands else h
        z = zx[:, t].float() + op @ w32
        i = torch.sigmoid(z[:, :hidden])
        f = torch.sigmoid(z[:, hidden:2 * hidden])
        g = torch.tanh(z[:, 2 * hidden:3 * hidden])
        o = torch.sigmoid(z[:, 3 * hidden:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys[:, t] = h
        cs[:, t] = c
        gs[:, t] = torch.cat([i, f, g, o], dim=-1)
    return ys, cs, gs


def lstm_backward_reference(w: torch.Tensor, ys: torch.Tensor,
                            c_seq: torch.Tensor, gates: torch.Tensor,
                            dy: torch.Tensor, reverse: bool = False,
                            round_operands: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One direction of the backward kernel in plain PyTorch, from the
    forward's residuals: (dzx in the residuals' dtype — fp32 with
    round_operands=False — and dW fp32 (H, 4H)), a reversed sweep with
    dh/dc carries in fp32."""
    n, n_t, h4 = gates.shape
    hidden = h4 // 4
    w32 = w.float()

    def operand(x):
        return x.to(w.dtype).float() if round_operands else x

    dh_carry = torch.zeros(n, hidden, device=gates.device)
    dc_carry = torch.zeros(n, hidden, device=gates.device)
    dw = torch.zeros(hidden, h4, device=gates.device)
    dzx = torch.empty(n, n_t, h4, device=gates.device,
                      dtype=gates.dtype if round_operands else torch.float32)
    for t, prev, live in reversed(list(_steps(n_t, reverse))):
        g32 = gates[:, t].float()
        i = g32[:, :hidden]
        f = g32[:, hidden:2 * hidden]
        g = g32[:, 2 * hidden:3 * hidden]
        o = g32[:, 3 * hidden:]
        c = c_seq[:, t].float()
        zero = torch.zeros_like(c)
        c_prev = c_seq[:, prev].float() if live else zero
        h_prev = ys[:, prev].float() if live else zero
        dh = dy[:, t].float() + dh_carry
        tc = torch.tanh(c)
        do_pre = dh * tc * o * (1.0 - o)
        dc = dc_carry + dh * o * (1.0 - tc * tc)
        dz = torch.cat([dc * g * i * (1.0 - i),
                        dc * c_prev * f * (1.0 - f),
                        dc * i * (1.0 - g * g), do_pre], dim=-1)
        dzx[:, t] = dz
        dzn = operand(dz)
        dh_carry = dzn @ w32.T
        dc_carry = dc * f
        dw = dw + operand(h_prev).T @ dzn
    return dzx, dw


def _forward_plain(zxs, ws, reverses):
    return [lstm_forward_reference(zx, w, rev)
            for zx, w, rev in zip(zxs, ws, reverses)]


def _backward_plain(ws, res, dys, reverses):
    out = [lstm_backward_reference(w, ys, c, g, dy, rev)
           for w, (ys, c, g), dy, rev in zip(ws, res, dys, reverses)]
    return [o[0] for o in out], [o[1] for o in out]


# ------------------------------------------------------------- CUDA
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_rnn")
    if lib.bigdl_lstm_fwd.argtypes is None:
        lib.bigdl_lstm_fwd.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.bigdl_lstm_fwd.restype = ctypes.c_int
        lib.bigdl_lstm_bwd.argtypes = (
            [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        lib.bigdl_lstm_bwd.restype = ctypes.c_int
        lib.bigdl_gru_fwd.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.bigdl_gru_fwd.restype = ctypes.c_int
        lib.bigdl_gru_bwd.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.bigdl_gru_bwd.restype = ctypes.c_int
        lib.bigdl_dw_max_splits.argtypes = [ctypes.c_int]
        lib.bigdl_dw_max_splits.restype = ctypes.c_int
        lib.bigdl_lstm_error_string.argtypes = [ctypes.c_int]
        lib.bigdl_lstm_error_string.restype = ctypes.c_char_p
    return lib


def _check(zxs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor]
           ) -> None:
    """What the kernels take: CUDA tensors on one device, zx (N, T, 4H)
    and W (H, 4H) alike in fp32 or bf16, H <= MAX_HIDDEN."""
    ref = zxs[0]
    n, n_t, h4 = ref.shape
    hidden = h4 // 4
    for name, t in [*(("zx", z) for z in zxs), *(("w_hh", w) for w in ws)]:
        if not t.is_cuda or t.device != ref.device:
            raise ValueError(f"fused_rnn impl='cuda': {name} must be a "
                             f"CUDA tensor on {ref.device}, got {t.device}")
        if t.dtype != ref.dtype or t.dtype not in (torch.float32,
                                                   torch.bfloat16):
            raise ValueError(f"fused_rnn impl='cuda' takes zx and w_hh in "
                             f"one dtype, float32 or bfloat16; got "
                             f"{[x.dtype for x in (*zxs, *ws)]}")
    for z in zxs:
        if z.shape != ref.shape:
            raise ValueError(f"fused_rnn: zx shapes differ {tuple(z.shape)}"
                             f" vs {tuple(ref.shape)}")
    for w in ws:
        if w.shape != (hidden, h4):
            raise ValueError(f"fused_rnn: w_hh {tuple(w.shape)} does not "
                             f"match zx {tuple(ref.shape)}: expected "
                             f"({hidden}, {h4})")
    if h4 % 4 or not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"fused_rnn impl='cuda' takes hidden sizes 1.."
                         f"{MAX_HIDDEN} (zx last dim 4H), got zx "
                         f"{tuple(ref.shape)}")
    if n < 1 or n_t < 1:
        raise ValueError(f"fused_rnn: empty batch or sequence "
                         f"{tuple(ref.shape)}")


def dw_split_plan(pairs: int, max_splits: int) -> Tuple[int, int]:
    """How the dW GEMM after a backward sweep splits a direction's
    `pairs` = N * T (t, row) pairs over the CTAs of a cluster: (splits,
    span), rank r summing pairs [r * span, min((r + 1) * span, pairs)),
    span a whole number of DW_PAIRS stages, at most `max_splits` ranks
    (the card's cluster limit for the dW kernel) and at most one a
    stage. A function of the pair count and that limit alone, so the
    order of dW's sums, and its bits, follow from the shape."""
    splits = min(max_splits, -(-pairs // DW_PAIRS))
    span = -(-pairs // splits)
    span = -(-span // DW_PAIRS) * DW_PAIRS
    return -(-pairs // span), span


_MAX_SPLITS = {}


def _dw_split(lib: ctypes.CDLL, pairs: int, bf16: bool,
              device: torch.device) -> Tuple[int, int]:
    key = (device.index, bf16)
    if key not in _MAX_SPLITS:
        got = lib.bigdl_dw_max_splits(int(bf16))
        _raise_on(max(0, -got), lib, "dW cluster query")
        _MAX_SPLITS[key] = got
    return dw_split_plan(pairs, _MAX_SPLITS[key])


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"fused_rnn {what} kernel launch failed: "
            f"{lib.bigdl_lstm_error_string(err).decode()} (cudaError {err})")


def _pair(xs: Sequence[Optional[torch.Tensor]]) -> List[int]:
    ptrs = [0 if x is None else x.data_ptr() for x in xs]
    return ptrs + [ptrs[0]] * (2 - len(ptrs))


def lstm_fwd_cuda(zxs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                  reverses: Sequence[bool], save: bool):
    """One forward launch over len(zxs) (1 or 2) directions. Returns a
    list of (ys, c, gates) per direction; c and gates are None when
    `save` is False (the inference variant)."""
    global fwd_train_launches, fwd_infer_launches
    zxs = [z.contiguous() for z in zxs]
    ws = [w.contiguous() for w in ws]
    _check(zxs, ws)
    n, n_t, h4 = zxs[0].shape
    hidden = h4 // 4
    ys = [zx.new_empty(n, n_t, hidden) for zx in zxs]
    cs = [zx.new_empty(n, n_t, hidden) if save else None for zx in zxs]
    gs = [torch.empty_like(zx) if save else None for zx in zxs]
    revs = [int(r) for r in reverses] + [0] * (2 - len(zxs))
    lib = _lib()
    with torch.cuda.device(zxs[0].device):
        stream = torch.cuda.current_stream(zxs[0].device).cuda_stream
        err = lib.bigdl_lstm_fwd(
            *_pair(zxs), *_pair(ws), *_pair(ys), *_pair(cs), *_pair(gs),
            *revs, len(zxs), n, n_t, hidden, int(save),
            int(zxs[0].dtype == torch.bfloat16), stream)
    _raise_on(err, lib, "forward")
    if save:
        fwd_train_launches += 1
    else:
        fwd_infer_launches += 1
    return list(zip(ys, cs, gs))


def lstm_bwd_cuda(ws: Sequence[torch.Tensor], res, dys: Sequence[torch.Tensor],
                  reverses: Sequence[bool]):
    """One backward call over the directions of `res` ((ys, c, gates)
    per direction): the sweep over every direction and the dW GEMM, two
    launches on the current stream, counted as one. Returns (dzx per
    direction, dW per direction as one (H, 4H) fp32, summed over the
    batch)."""
    global bwd_launches
    ws = [w.contiguous() for w in ws]
    res = [tuple(x.contiguous() for x in r) for r in res]
    dys = [dy.to(res[0][0].dtype).contiguous() for dy in dys]
    gates = [r[2] for r in res]
    _check(gates, ws)
    n, n_t, h4 = gates[0].shape
    hidden = h4 // 4
    for (ys, c, _), dy in zip(res, dys):
        for name, t in (("ys", ys), ("c", c), ("dy", dy)):
            if t.shape != (n, n_t, hidden) or t.dtype != gates[0].dtype:
                raise ValueError(f"fused_rnn backward: {name} "
                                 f"{tuple(t.shape)} {t.dtype} does not "
                                 f"match gates {tuple(gates[0].shape)}")
    bf16 = gates[0].dtype == torch.bfloat16
    # the bf16 tensor-core product reads W as stored (K-major), the fp32
    # SIMT product one column of W^T per thread
    ws = [w if bf16 else w.t().contiguous() for w in ws]
    dzxs = [torch.empty_like(g) for g in gates]
    dws = [torch.empty(hidden, h4, dtype=torch.float32, device=g.device)
           for g in gates]
    revs = [int(r) for r in reverses] + [0] * (2 - len(gates))
    lib = _lib()
    with torch.cuda.device(gates[0].device):
        split = _dw_split(lib, n * n_t, bf16, gates[0].device)
        stream = torch.cuda.current_stream(gates[0].device).cuda_stream
        err = lib.bigdl_lstm_bwd(
            *_pair(ws), *_pair([r[0] for r in res]),
            *_pair([r[1] for r in res]), *_pair(gates), *_pair(dys),
            *_pair(dzxs), *_pair(dws), *revs, len(gates), n, n_t, hidden,
            *split, int(bf16), stream)
    _raise_on(err, lib, "backward")
    bwd_launches += 1
    return dzxs, dws


# ------------------------------------------------------- autograd
def _forward(impl, zxs, ws, reverses, save):
    if impl == "torch":
        out = _forward_plain(zxs, ws, reverses)
        return out if save else [(o[0], None, None) for o in out]
    return lstm_fwd_cuda(zxs, ws, reverses, save)


class _LSTMScan(torch.autograd.Function):
    """ys per direction, differentiable in every zx and w_hh. Forward
    saves (w, ys, c, gates) per direction, as `_lstm_core_fwd` /
    `_bilstm_core_fwd` do; backward is one backward call (or the plain
    backward), whose fp32 dW, summed over the batch, is cast to W's
    dtype."""

    @staticmethod
    def forward(ctx, impl, reverses, *tensors):
        ndir = len(reverses)
        zxs, ws = tensors[:ndir], tensors[ndir:]
        res = _forward(impl, zxs, ws, reverses, True)
        ctx.save_for_backward(*ws, *(x for r in res for x in r))
        ctx.impl, ctx.reverses = impl, reverses
        ctx.set_materialize_grads(False)
        return tuple(r[0] for r in res)

    @staticmethod
    def backward(ctx, *dys):
        ndir = len(ctx.reverses)
        saved = ctx.saved_tensors
        ws, flat = saved[:ndir], saved[ndir:]
        res = [tuple(flat[3 * i:3 * i + 3]) for i in range(ndir)]
        dys = [torch.zeros_like(r[0]) if dy is None else dy
               for dy, r in zip(dys, res)]
        if ctx.impl == "torch":
            dzxs, dws = _backward_plain(ws, res, dys, ctx.reverses)
        else:
            dzxs, dws = lstm_bwd_cuda(ws, res, dys, ctx.reverses)
        dws = [dw.to(w.dtype) for dw, w in zip(dws, ws)]
        return (None, None, *dzxs, *dws)


def _check_block_n(block_n: Optional[int]) -> None:
    if block_n not in (None, BLOCK_N):
        raise ValueError(f"fused_rnn block_n {block_n}: the kernels' batch "
                         f"tile is fixed at {BLOCK_N} rows (pass None)")


def _scan(zxs, ws, reverses, impl, block_n):
    impl = _resolve_impl(zxs[0], impl)
    _check_block_n(block_n)
    tensors = (*zxs, *ws)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _LSTMScan.apply(impl, tuple(reverses), *tensors)
    return tuple(r[0] for r in _forward(impl, zxs, ws, reverses, False))


def lstm_scan(zx: torch.Tensor, w_hh: torch.Tensor,
              impl: Optional[str] = None,
              block_n: Optional[int] = None) -> torch.Tensor:
    """The whole LSTM time loop in one launch. zx: (N, T, 4H) hoisted
    input projections including bias (`precompute_inputs`); w_hh:
    (H, 4H). Returns the hidden-state sequence (N, T, H) in zx's dtype,
    differentiable in both."""
    return _scan((zx,), (w_hh,), (False,), impl, block_n)[0]


def bilstm_scan(zx_f: torch.Tensor, zx_b: torch.Tensor, w_f: torch.Tensor,
                w_b: torch.Tensor, impl: Optional[str] = None,
                block_n: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both LSTM directions in one launch. zx_f / zx_b: (N, T, 4H)
    projections of the same, unflipped input through each direction's
    weights. Returns (ys_fwd, ys_bwd), both in true time order (ys_bwd[t]
    is the reverse pass's state after consuming x[T-1..t])."""
    ys_f, ys_b = _scan((zx_f, zx_b), (w_f, w_b), (False, True), impl,
                       block_n)
    return ys_f, ys_b




# ------------------------------------------------------------- GRU
def gru_forward_reference(zg: torch.Tensor, zc: torch.Tensor,
                          wg: torch.Tensor, wc: torch.Tensor,
                          round_operands: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The GRU forward kernel in plain PyTorch: (ys, zr, cand), (N, T, H),
    (N, T, 2H), (N, T, H) in zg's dtype (fp32 with round_operands=False).
    zr = sigmoid(zg_t + h . W_g), cand = tanh(zc_t + (r h) . W_c),
    h' = (1 - z) h + z cand, the h carry in fp32."""
    n, n_t, h2 = zg.shape
    hidden = h2 // 2
    out_dtype = zg.dtype if round_operands else torch.float32
    wg32, wc32 = wg.float(), wc.float()

    def operand(x, w):
        return x.to(w.dtype).float() if round_operands else x

    h = torch.zeros(n, hidden, device=zg.device)
    ys = torch.empty(n, n_t, hidden, dtype=out_dtype, device=zg.device)
    zrs = torch.empty(n, n_t, h2, dtype=out_dtype, device=zg.device)
    cands = torch.empty(n, n_t, hidden, dtype=out_dtype, device=zg.device)
    for t in range(n_t):
        zr = torch.sigmoid(zg[:, t].float() + operand(h, wg) @ wg32)
        z, r = zr[:, :hidden], zr[:, hidden:]
        cand = torch.tanh(zc[:, t].float() + operand(r * h, wc) @ wc32)
        h = (1.0 - z) * h + z * cand
        ys[:, t] = h
        zrs[:, t] = zr
        cands[:, t] = cand
    return ys, zrs, cands


def gru_backward_reference(wg: torch.Tensor, wc: torch.Tensor,
                           ys: torch.Tensor, zr: torch.Tensor,
                           cand: torch.Tensor, dy: torch.Tensor,
                           round_operands: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """The GRU backward kernel in plain PyTorch, from the forward's
    residuals: (dzg, dzc in zr's dtype — fp32 with round_operands=False —
    and dW_g (H, 2H), dW_c (H, H) in fp32), a reversed sweep with the dh
    carry in fp32 and h_prev read back from the stored ys."""
    n, n_t, h2 = zr.shape
    hidden = h2 // 2
    out_dtype = zr.dtype if round_operands else torch.float32
    wg32, wc32 = wg.float(), wc.float()

    def operand(x, w):
        return x.to(w.dtype).float() if round_operands else x

    dev = zr.device
    dh_carry = torch.zeros(n, hidden, device=dev)
    dwg = torch.zeros(hidden, h2, device=dev)
    dwc = torch.zeros(hidden, hidden, device=dev)
    dzg = torch.empty(n, n_t, h2, dtype=out_dtype, device=dev)
    dzc = torch.empty(n, n_t, hidden, dtype=out_dtype, device=dev)
    for t in reversed(range(n_t)):
        zr32 = zr[:, t].float()
        z, r = zr32[:, :hidden], zr32[:, hidden:]
        c = cand[:, t].float()
        hp = ys[:, t - 1].float() if t > 0 else torch.zeros_like(c)
        dh = dy[:, t].float() + dh_carry
        dz = dh * (c - hp)
        dcp = dh * z * (1.0 - c * c)
        dzc[:, t] = dcp
        dcn = operand(dcp, wc)
        drh = dcn @ wc32.T
        dh_prev = dh * (1.0 - z) + drh * r
        dzr = torch.cat([dz * z * (1.0 - z), drh * hp * r * (1.0 - r)], -1)
        dzg[:, t] = dzr
        dzrn = operand(dzr, wg)
        dh_carry = dh_prev + dzrn @ wg32.T
        dwg = dwg + operand(hp, wg).T @ dzrn
        dwc = dwc + operand(r * hp, wc).T @ dcn
    return dzg, dzc, dwg, dwc


def _gru_check(zg: torch.Tensor, zc: torch.Tensor, wg: torch.Tensor,
               wc: torch.Tensor) -> None:
    """What the GRU kernels take: CUDA tensors on one device, alike in
    fp32 or bf16, zg (N, T, 2H), zc (N, T, H), W_g (H, 2H), W_c (H, H),
    H <= MAX_HIDDEN."""
    named = (("zx_gates", zg), ("zx_cand", zc), ("w_g", wg), ("w_c", wc))
    for name, t in named:
        if not t.is_cuda or t.device != zg.device:
            raise ValueError(f"gru_scan impl='cuda': {name} must be a CUDA "
                             f"tensor on {zg.device}, got {t.device}")
        if t.dtype != zg.dtype or t.dtype not in (torch.float32,
                                                  torch.bfloat16):
            raise ValueError(f"gru_scan impl='cuda' takes its inputs in one "
                             f"dtype, float32 or bfloat16; got "
                             f"{[x.dtype for _, x in named]}")
    n, n_t, h2 = zg.shape
    hidden = h2 // 2
    want = [(n, n_t, 2 * hidden), (n, n_t, hidden), (hidden, 2 * hidden),
            (hidden, hidden)]
    shapes = [tuple(t.shape) for _, t in named]
    if h2 % 2 or shapes != want:
        raise ValueError(f"gru_scan: shapes {shapes} do not match (N, T, 2H),"
                         f" (N, T, H), (H, 2H), (H, H)")
    if not 1 <= hidden <= MAX_HIDDEN or n < 1 or n_t < 1:
        raise ValueError(f"gru_scan impl='cuda' takes hidden sizes 1.."
                         f"{MAX_HIDDEN} and a non-empty batch and "
                         f"sequence, got zx_gates {tuple(zg.shape)}")


def gru_fwd_cuda(zg: torch.Tensor, zc: torch.Tensor, wg: torch.Tensor,
                 wc: torch.Tensor, save: bool):
    """One GRU forward launch. Returns (ys, zr, cand); zr and cand are
    None when `save` is False (the inference variant)."""
    global gru_fwd_train_launches, gru_fwd_infer_launches
    zg, zc, wg, wc = (x.contiguous() for x in (zg, zc, wg, wc))
    _gru_check(zg, zc, wg, wc)
    n, n_t, h2 = zg.shape
    ys = zg.new_empty(n, n_t, h2 // 2)
    zr = torch.empty_like(zg) if save else None
    cand = torch.empty_like(zc) if save else None
    lib = _lib()
    with torch.cuda.device(zg.device):
        stream = torch.cuda.current_stream(zg.device).cuda_stream
        err = lib.bigdl_gru_fwd(
            zg.data_ptr(), zc.data_ptr(), wg.data_ptr(), wc.data_ptr(),
            ys.data_ptr(), *_pair([zr, cand]), n, n_t, h2 // 2, int(save),
            int(zg.dtype == torch.bfloat16), stream)
    _raise_on(err, lib, "GRU forward")
    if save:
        gru_fwd_train_launches += 1
    else:
        gru_fwd_infer_launches += 1
    return ys, zr, cand


def gru_bwd_cuda(wg: torch.Tensor, wc: torch.Tensor, ys: torch.Tensor,
                 zr: torch.Tensor, cand: torch.Tensor, dy: torch.Tensor):
    """One GRU backward call from the forward's residuals: the sweep and
    the dW GEMM, two launches on the current stream, counted as one.
    Returns (dzg, dzc, dW_g (H, 2H) fp32, dW_c (H, H) fp32), dW summed
    over the batch."""
    global gru_bwd_launches
    ys, zr, cand = (x.contiguous() for x in (ys, zr, cand))
    dy = dy.to(ys.dtype).contiguous()
    _gru_check(zr, cand, wg, wc)
    if ys.shape != cand.shape or dy.shape != cand.shape \
            or ys.dtype != zr.dtype:
        raise ValueError(f"gru_scan backward: ys {tuple(ys.shape)} "
                         f"{ys.dtype} and dy {tuple(dy.shape)} do not match "
                         f"cand {tuple(cand.shape)} {zr.dtype}")
    n, n_t, h2 = zr.shape
    hidden = h2 // 2
    bf16 = zr.dtype == torch.bfloat16
    # the bf16 tensor-core products read W as stored (K-major), the fp32
    # SIMT products one column of W^T per thread
    wg, wc = ((w.contiguous() if bf16 else w.t().contiguous())
              for w in (wg, wc))
    dzg, dzc = torch.empty_like(zr), torch.empty_like(cand)
    dwg = torch.empty(hidden, h2, dtype=torch.float32, device=zr.device)
    dwc = torch.empty(hidden, hidden, dtype=torch.float32, device=zr.device)
    lib = _lib()
    with torch.cuda.device(zr.device):
        split = _dw_split(lib, n * n_t, bf16, zr.device)
        stream = torch.cuda.current_stream(zr.device).cuda_stream
        err = lib.bigdl_gru_bwd(
            wg.data_ptr(), wc.data_ptr(), ys.data_ptr(), zr.data_ptr(),
            cand.data_ptr(), dy.data_ptr(), dzg.data_ptr(), dzc.data_ptr(),
            dwg.data_ptr(), dwc.data_ptr(), n, n_t, hidden, *split,
            int(bf16), stream)
    _raise_on(err, lib, "GRU backward")
    gru_bwd_launches += 1
    return dzg, dzc, dwg, dwc


def _gru_forward(impl, zg, zc, wg, wc, save):
    if impl == "torch":
        out = gru_forward_reference(zg, zc, wg, wc)
        return out if save else (out[0], None, None)
    return gru_fwd_cuda(zg, zc, wg, wc, save)


class _GRUScan(torch.autograd.Function):
    """ys, differentiable in zg, zc, W_g and W_c. Forward saves (W_g,
    W_c, ys, zr, cand), as `_gru_core_fwd` does; backward is one backward
    call (or the plain backward), whose fp32 dW, summed over the batch,
    is cast to W's dtype."""

    @staticmethod
    def forward(ctx, impl, zg, zc, wg, wc):
        ys, zr, cand = _gru_forward(impl, zg, zc, wg, wc, True)
        ctx.save_for_backward(wg, wc, ys, zr, cand)
        ctx.impl = impl
        ctx.set_materialize_grads(False)
        return ys

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return None, None, None, None, None
        wg, wc, ys, zr, cand = ctx.saved_tensors
        if ctx.impl == "torch":
            dzg, dzc, dwg, dwc = gru_backward_reference(
                wg, wc, ys, zr, cand, dy.to(ys.dtype))
        else:
            dzg, dzc, dwg, dwc = gru_bwd_cuda(wg, wc, ys, zr, cand, dy)
        return None, dzg, dzc, dwg.to(wg.dtype), dwc.to(wc.dtype)


def gru_scan(zx_gates: torch.Tensor, zx_cand: torch.Tensor,
             w_g: torch.Tensor, w_c: torch.Tensor,
             impl: Optional[str] = None,
             block_n: Optional[int] = None) -> torch.Tensor:
    """The whole GRU time loop in one launch. zx_gates: (N, T, 2H)
    hoisted (z, r) gate projections including bias; zx_cand: (N, T, H)
    hoisted candidate projection including bias; w_g: (H, 2H); w_c:
    (H, H). Returns the hidden-state sequence (N, T, H) in zx_gates'
    dtype, differentiable in all four."""
    impl = _resolve_impl(zx_gates, impl)
    _check_block_n(block_n)
    tensors = (zx_gates, zx_cand, w_g, w_c)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _GRUScan.apply(impl, *tensors)
    return _gru_forward(impl, *tensors, False)[0]
