"""Recurrent layers.

Ports bigdl_tpu/nn/recurrent.py (reference: nn/Recurrent.scala,
nn/RnnCell.scala, nn/LSTM.scala, nn/LSTMPeephole.scala, nn/GRU.scala,
nn/BiRecurrent.scala, nn/TimeDistributed.scala). Input is batch-major
(N, T, D), as in the JAX package; parameter trees keep its names and
layouts (the LSTM weight is (D + H, 4H), gates i, f, g, o).

Cells expose `init_params(generator)`, `init_carry(batch, like)` and
`step(params, carry, x_t, training, rng) -> (new_carry, y_t)`; cells
with a hoisted-input protocol add `precompute_inputs` (the
time-independent x . W_x half of every gate product, run once for the
whole sequence) and `step_precomputed` (the recurrent half only).

`Recurrent.apply` keeps the JAX package's dispatch: with the hoisted
protocol and `fused` not False, a cell with `fused_scan` (LSTM, GRU)
runs the whole time loop through ops/fused_rnn.py — `fused=None`
resolves by the tensors' device (the CUDA kernel on CUDA tensors, the
plain version on CPU tensors), a string forces that `impl` ("cuda" or
"torch"). `fused=False` runs the per-step loop, the JAX package's own
`lax.scan` route, as does `return_state=True` (the kernels do not emit
the final carry). `BiRecurrent` of two equal-sized LSTMs runs both
directions in one `bilstm_scan` launch; any other pair, a GRU pair
included, runs one `Recurrent` per direction, the backward one on
time-flipped input, as the JAX package does (two `gru_scan` launches).
`unroll` is accepted for signature parity and has no effect (a Python
loop has nothing to unroll). Per-step `rng` folding is kept
(`_fold_rng`), though no ported cell draws from it.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from bigdl_tpu_torch.nn.initialization import Xavier
from bigdl_tpu_torch.nn.module import Module, _fold_rng
from bigdl_tpu_torch.ops import fused_rnn


class Cell(Module):
    """Base recurrent cell."""

    hidden_size: int

    def init_carry(self, batch: int, like: torch.Tensor):
        """The zero carry for `batch` rows, on like's device (fp32, as
        the JAX package's)."""
        raise NotImplementedError

    def step(self, params, carry, x_t, training=False, rng=None):
        raise NotImplementedError

    def apply(self, variables, inputs, training=False, rng=None):
        """A cell applied directly acts on (x_t, carry) — rarely used;
        Recurrent is the normal path."""
        x_t, carry = inputs
        new_carry, y = self.step(variables["params"], carry, x_t, training,
                                 rng)
        return (y, new_carry), variables["state"]


def _mm(a, b):
    """a @ b in the promoted dtype, as jnp's matmul promotes mixed
    operands (an fp32 carry against bf16 weights computes in fp32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _zeros(batch, size, like):
    return torch.zeros(batch, size, device=like.device)


def _dense_init(generator, in_size, out_size, with_bias=True):
    p = {"weight": Xavier()(generator, (in_size, out_size), fan_in=in_size,
                            fan_out=out_size)}
    if with_bias:
        p["bias"] = torch.zeros(out_size)
    return p


class RnnCell(Cell):
    """Vanilla RNN cell: h' = act(x W_x + b + h W_h)
    (reference: nn/RnnCell.scala; Tanh by default)."""

    def __init__(self, input_size: int, hidden_size: int,
                 activation=torch.tanh, name: Optional[str] = None):
        super().__init__(name=name)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation

    def init_params(self, generator=None):
        return {"i2h": _dense_init(generator, self.input_size,
                                   self.hidden_size),
                "h2h": _dense_init(generator, self.hidden_size,
                                   self.hidden_size, with_bias=False)}

    def init_carry(self, batch, like):
        return _zeros(batch, self.hidden_size, like)

    def step(self, params, carry, x_t, training=False, rng=None):
        h = self.activation(x_t @ params["i2h"]["weight"]
                            + params["i2h"]["bias"]
                            + _mm(carry, params["h2h"]["weight"]))
        return h, h


class LSTM(Cell):
    """LSTM cell (reference: nn/LSTM.scala): the gates come from one
    fused (D + H, 4H) product."""

    def __init__(self, input_size: int, hidden_size: int,
                 forget_bias: float = 0.0, name: Optional[str] = None):
        super().__init__(name=name)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.forget_bias = forget_bias

    def init_params(self, generator=None):
        h = self.hidden_size
        p = _dense_init(generator, self.input_size + h, 4 * h)
        if self.forget_bias:
            p["bias"][h:2 * h] = self.forget_bias
        return p

    def init_carry(self, batch, like):
        z = _zeros(batch, self.hidden_size, like)
        return (z, z)  # (h, c)

    def step(self, params, carry, x_t, training=False, rng=None):
        h_prev, c_prev = carry
        z = _mm(torch.cat([x_t, h_prev], dim=-1), params["weight"]) \
            + params["bias"]
        return self._gates(z, c_prev)

    @staticmethod
    def _gates(z, c_prev):
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), h

    # ---- hoisted-input protocol ---------------------------------------
    def precompute_inputs(self, params, x):
        d = self.input_size
        return x @ params["weight"][:d] + params["bias"]  # (N, T, 4H)

    def step_precomputed(self, params, carry, z_t, training=False,
                         rng=None):
        h_prev, c_prev = carry
        z = z_t + _mm(h_prev, params["weight"][self.input_size:])
        return self._gates(z, c_prev)

    # ---- persistent-kernel protocol -----------------------------------
    def fused_scan(self, params, zx, impl=None):
        """The whole time loop over the hoisted feed in one
        ops/fused_rnn.lstm_scan call (kernel or plain version by
        `impl`)."""
        return fused_rnn.lstm_scan(zx, params["weight"][self.input_size:],
                                   impl=impl)


class LSTMPeephole(Cell):
    """LSTM with peephole connections (reference: nn/LSTMPeephole.scala)."""

    def __init__(self, input_size: int, hidden_size: int,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.input_size = input_size
        self.hidden_size = hidden_size

    def init_params(self, generator=None):
        p = _dense_init(generator, self.input_size + self.hidden_size,
                        4 * self.hidden_size)
        peep = 0.1 * torch.randn(3, self.hidden_size, generator=generator)
        return {"weight": p["weight"], "bias": p["bias"], "peephole": peep}

    def init_carry(self, batch, like):
        z = _zeros(batch, self.hidden_size, like)
        return (z, z)

    def step(self, params, carry, x_t, training=False, rng=None):
        h_prev, c_prev = carry
        z = _mm(torch.cat([x_t, h_prev], dim=-1), params["weight"]) \
            + params["bias"]
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        pi, pf, po = params["peephole"]
        i = torch.sigmoid(i + pi * c_prev)
        f = torch.sigmoid(f + pf * c_prev)
        c = f * c_prev + i * torch.tanh(g)
        o = torch.sigmoid(o + po * c)
        h = o * torch.tanh(c)
        return (h, c), h


class GRU(Cell):
    """GRU cell (reference: nn/GRU.scala)."""

    def __init__(self, input_size: int, hidden_size: int,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.input_size = input_size
        self.hidden_size = hidden_size

    def init_params(self, generator=None):
        d, h = self.input_size, self.hidden_size
        return {"gates": _dense_init(generator, d + h, 2 * h),
                "cand": _dense_init(generator, d + h, h)}

    def init_carry(self, batch, like):
        return _zeros(batch, self.hidden_size, like)

    def step(self, params, carry, x_t, training=False, rng=None):
        zr = _mm(torch.cat([x_t, carry], -1), params["gates"]["weight"]) \
            + params["gates"]["bias"]
        z, r = torch.chunk(torch.sigmoid(zr), 2, dim=-1)
        cand = torch.tanh(_mm(torch.cat([x_t, r * carry], -1),
                              params["cand"]["weight"])
                          + params["cand"]["bias"])
        h = (1.0 - z) * carry + z * cand
        return h, h

    # ---- hoisted-input protocol ---------------------------------------
    def precompute_inputs(self, params, x):
        d = self.input_size
        zx = x @ params["gates"]["weight"][:d] + params["gates"]["bias"]
        cx = x @ params["cand"]["weight"][:d] + params["cand"]["bias"]
        return torch.cat([zx, cx], dim=-1)  # (N, T, 3H)

    def step_precomputed(self, params, carry, z_t, training=False,
                         rng=None):
        d, h = self.input_size, self.hidden_size
        zx, cx = z_t[..., :2 * h], z_t[..., 2 * h:]
        zr = zx + _mm(carry, params["gates"]["weight"][d:])
        z, r = torch.chunk(torch.sigmoid(zr), 2, dim=-1)
        cand = torch.tanh(cx + _mm(r * carry, params["cand"]["weight"][d:]))
        h_new = (1.0 - z) * carry + z * cand
        return h_new, h_new

    # ---- persistent-kernel protocol -----------------------------------
    def fused_scan(self, params, zx, impl=None):
        """The whole time loop over the hoisted feed in one
        ops/fused_rnn.gru_scan call (kernel or plain version by
        `impl`)."""
        d, h = self.input_size, self.hidden_size
        return fused_rnn.gru_scan(
            zx[..., :2 * h], zx[..., 2 * h:],
            params["gates"]["weight"][d:], params["cand"]["weight"][d:],
            impl=impl)


class ConvLSTMPeephole(Cell):
    """Convolutional LSTM cell over image sequences (reference:
    nn/ConvLSTMPeephole.scala): the gates are one fused convolution over
    [x_t, h] giving 4·C_out channels (i, f, g, o), with optional
    per-channel peepholes `w_ci`, `w_cf` on c_prev and `w_co` on the new
    c. Frames are NHWC and the weight HWIO; the convolution runs on
    cuDNN over the NHWC view (nn/conv.py) with stride 1 and the JAX
    package's SAME padding, (k - 1) // 2 before and k // 2 after, so an
    even kernel pads asymmetrically and the state keeps the frame's
    spatial size. Use inside `Recurrent` over (N, T, H, W, C) input."""

    def __init__(self, input_size: int, output_size: int,
                 kernel: int = 3, with_peephole: bool = True,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.input_size = input_size
        self.output_size = output_size
        self.kernel = kernel
        self.with_peephole = with_peephole
        self.hidden_size = output_size

    def init_params(self, generator=None):
        k, ci, co = self.kernel, self.input_size, self.output_size
        p = {"weight": Xavier()(generator, (k, k, ci + co, 4 * co),
                                fan_in=(ci + co) * k * k,
                                fan_out=4 * co * k * k),
             "bias": torch.zeros(4 * co)}
        if self.with_peephole:
            for key in ("w_ci", "w_cf", "w_co"):
                p[key] = torch.zeros(co)
        return p

    def init_carry_like(self, x_t):
        b, h, w, _ = x_t.shape
        z = torch.zeros(b, h, w, self.output_size, dtype=x_t.dtype,
                        device=x_t.device)
        return (z, z)  # (h, c)

    def step(self, params, carry, x_t, training=False, rng=None):
        from bigdl_tpu_torch.nn.conv import _conv2d_nhwc, _same_pads

        h_prev, c_prev = carry
        k = self.kernel
        pad = _same_pads(x_t.shape[1], k, 1)
        z = _conv2d_nhwc(torch.cat([x_t, h_prev], dim=-1), params["weight"],
                         (1, 1), (pad, _same_pads(x_t.shape[2], k, 1))) \
            + params["bias"]
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        if self.with_peephole:
            i = i + params["w_ci"] * c_prev
            f = f + params["w_cf"] * c_prev
        c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
        if self.with_peephole:
            o = o + params["w_co"] * c
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), h


class Recurrent(Module):
    """Drive a cell across time (reference: nn/Recurrent.scala): input
    (N, T, D) -> output (N, T, H), or (N, T, H, W, C) frames for a
    convolutional cell; `return_state=True` returns
    (output, final carry). `.add(cell)` mirrors the reference's
    `Recurrent().add(LSTM(...))`. `fused` and `unroll` as in the module
    docstring."""

    def __init__(self, cell: Optional[Cell] = None,
                 return_state: bool = False, unroll: int = 1,
                 hoist_inputs: bool = True, *, fused=None,
                 name: Optional[str] = None):
        super().__init__(name=name)
        if fused not in (None, False) and fused not in fused_rnn.IMPLS:
            raise ValueError(f"fused {fused!r}: expected None, False or "
                             f"one of {fused_rnn.IMPLS}")
        self.cell = cell
        self.return_state = return_state
        self.unroll = unroll
        self.hoist_inputs = hoist_inputs
        self.fused = fused

    def add(self, cell: Cell) -> "Recurrent":
        self._record_mutation("add", cell)
        self.cell = cell
        return self

    def init_params(self, generator=None):
        return {"cell": self.cell.init_params(generator)}

    def apply(self, variables, x, training=False, rng=None):
        cell_params = variables["params"]["cell"]
        step_fn = self.cell.step
        feed = x
        if (self.hoist_inputs and hasattr(self.cell, "precompute_inputs")
                and hasattr(self.cell, "step_precomputed")):
            feed = self.cell.precompute_inputs(cell_params, x)
            step_fn = self.cell.step_precomputed
            if (self.fused is not False and not self.return_state
                    and hasattr(self.cell, "fused_scan")):
                impl = self.fused if isinstance(self.fused, str) else None
                return (self.cell.fused_scan(cell_params, feed, impl=impl),
                        variables["state"])
        if hasattr(self.cell, "init_carry_like"):
            # a cell whose state is shaped by the frame (ConvLSTMPeephole:
            # (N, H, W, C_out) from (N, T, H, W, C) input)
            carry = self.cell.init_carry_like(x[:, 0])
        else:
            carry = self.cell.init_carry(x.shape[0], x)
        ys = []
        for t in range(feed.shape[1]):
            carry, y = step_fn(cell_params, carry, feed[:, t], training,
                               _fold_rng(rng, t))
            ys.append(y)
        out = torch.stack(ys, dim=1)
        if self.return_state:
            return (out, carry), variables["state"]
        return out, variables["state"]


class BiRecurrent(Module):
    """Bidirectional recurrence, outputs merged by `merge` "concat"
    (default, the reference's JoinTable) or "add" (reference:
    nn/BiRecurrent.scala)."""

    def __init__(self, cell_fwd: Cell, cell_bwd: Optional[Cell] = None,
                 merge: str = "concat", unroll: int = 1,
                 hoist_inputs: bool = True, *, fused=None,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.fwd = Recurrent(cell_fwd, unroll=unroll,
                             hoist_inputs=hoist_inputs, fused=fused)
        self.bwd = Recurrent(cell_bwd if cell_bwd is not None
                             else copy.deepcopy(cell_fwd), unroll=unroll,
                             hoist_inputs=hoist_inputs, fused=fused)
        self.merge = merge
        self.fused = fused

    def init_params(self, generator=None):
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        return {"fwd": self.fwd.init_params(g),
                "bwd": self.bwd.init_params(g)}

    def _fused_bidir(self, variables, x):
        """Both directions in one ops/fused_rnn.bilstm_scan call, outputs
        in true time order; None off that route."""
        if self.fused is False or not (self.fwd.hoist_inputs
                                       and self.bwd.hoist_inputs):
            return None
        cf, cb = self.fwd.cell, self.bwd.cell
        if not (isinstance(cf, LSTM) and isinstance(cb, LSTM)
                and cf.hidden_size == cb.hidden_size
                and cf.input_size == cb.input_size):
            return None
        pf = variables["params"]["fwd"]["cell"]
        pb = variables["params"]["bwd"]["cell"]
        d = cf.input_size
        impl = self.fused if isinstance(self.fused, str) else None
        return fused_rnn.bilstm_scan(
            cf.precompute_inputs(pf, x), cb.precompute_inputs(pb, x),
            pf["weight"][d:], pb["weight"][d:], impl=impl)

    def apply(self, variables, x, training=False, rng=None):
        both = self._fused_bidir(variables, x)
        if both is not None:
            fwd_out, bwd_out = both
        else:
            fwd_out, _ = self.fwd.apply(
                {"params": variables["params"]["fwd"], "state": {}}, x,
                training=training, rng=_fold_rng(rng, 0))
            bwd_out, _ = self.bwd.apply(
                {"params": variables["params"]["bwd"], "state": {}},
                torch.flip(x, dims=(1,)), training=training,
                rng=_fold_rng(rng, 1))
            bwd_out = torch.flip(bwd_out, dims=(1,))
        if self.merge == "concat":
            out = torch.cat([fwd_out, bwd_out], dim=-1)
        elif self.merge == "add":
            out = fwd_out + bwd_out
        else:
            raise ValueError(f"unknown merge {self.merge!r}")
        return out, variables["state"]


class TimeDistributed(Module):
    """Apply a module at every timestep by folding T into the batch
    (reference: nn/TimeDistributed.scala)."""

    def __init__(self, module: Module, name: Optional[str] = None):
        super().__init__(name=name)
        self.module = module

    def init_params(self, generator=None):
        return {"inner": self.module.init_params(generator)}

    def init_state(self):
        return {"inner": self.module.init_state()}

    def apply(self, variables, x, training=False, rng=None):
        n, t = x.shape[0], x.shape[1]
        out, s = self.module.apply(
            {"params": variables["params"]["inner"],
             "state": variables["state"]["inner"]},
            x.reshape((n * t,) + tuple(x.shape[2:])), training=training,
            rng=rng)
        return out.reshape((n, t) + tuple(out.shape[1:])), {"inner": s}
