"""L-BFGS with a strong-Wolfe or Armijo line search.

Ports bigdl_tpu/optim/lbfgs.py (reference: optim/LBFGS.scala — the
two-loop recursion over a history of (s, y) pairs, tolFun/tolX
termination — and optim/LineSearch.scala#lswolfe). As in the
reference, `minimize(feval, x0)` re-evaluates a closure during the line
search, a different contract from the gradient-based
`OptimMethod.update` of the training loop.

The JAX package runs the whole optimization as one `lax.while_loop`
over fixed-shape ring buffers, evaluating both sides of every branch
and picking one with `_select`. Here it is a Python loop over tensors
on the device of `x0` that takes only the branch JAX selects, so it
makes the same decisions: the same first step (`learningrate` along
-g), the same ring order of (s, y) pairs (a pair is admitted only when
s.y > 1e-10), the same bracket-then-zoom search with `_cubic_min`, the
same fallbacks when the search is exhausted, the same tolfun / tolx /
max_iter exits and the same count of function evaluations (`.evals`;
the zoom stage's degenerate-bracket exit evaluates and counts its
point, as JAX's does). Each decision reads a value on the host, so an
iteration synchronises with the device a few times.

`x0` is a tensor or a tree (nested dicts, lists, tuples) of tensors;
`feval` maps one of the same shape to a scalar tensor. The tree is
flattened into one vector (leaves in `models.convert.tree_leaves`
order, as `ravel_pytree` orders them) and differentiated with
`torch.autograd.grad`.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import torch

from bigdl_tpu_torch.models.convert import tree_leaves, tree_unflatten

_BRACKET, _ZOOM, _DONE = 0, 1, 2


def _cubic_min(x1, f1, g1, x2, f2, g2, lo, hi):
    """Minimizer of the cubic through (x1, f1, g1), (x2, f2, g2),
    clipped to [lo, hi]; bisection when the cubic has no real minimum
    (reference: LineSearch.scala's polynomial interpolation)."""
    d1 = g1 + g2 - 3.0 * (f1 - f2) / (x1 - x2)
    d2sq = d1 * d1 - g1 * g2
    d2 = torch.sqrt(torch.clamp_min(d2sq, 0.0))
    t = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2.0 * d2))
    mid = 0.5 * (x1 + x2)
    t = torch.where(d2sq >= 0.0, t, mid)
    t = torch.where(torch.isfinite(t), t, mid)
    return torch.minimum(torch.maximum(t, lo), hi)


def _strong_wolfe(vg, x, t0, d, f0, g0, gtd0, c1, c2, max_ls):
    """Strong-Wolfe line search (reference: LineSearch.scala#lswolfe).

    Brackets a step interval by cubic extrapolation, then zooms with
    cubic interpolation until both conditions hold:
        f(t) <= f0 + c1 t g0.d        (sufficient decrease)
        |g(t).d| <= -c2 g0.d          (strong curvature)
    Returns (t, f_t, g_t, evaluations). An exhausted search returns the
    zoom bracket's low end, or in the bracket stage the current point
    only if it passes sufficient decrease, else the previous one (the
    origin at first): never an ascent."""
    f1, g1 = vg(x + t0 * d)
    zero = torch.zeros_like(t0)
    stage, nev, it = _BRACKET, 1, 0
    tp, fp, gtdp, gp = zero, f0, gtd0, g0          # previous point
    t, f, g = t0, f1, g1                           # current point
    lo = (zero, f0, gtd0, g0)                      # zoom bracket
    hi = (zero, f0, gtd0, g0)
    while stage != _DONE and nev < max_ls:
        if stage == _ZOOM:
            lo_t, lo_f, lo_gtd, lo_g = lo
            hi_t = hi[0]
            a, b = torch.minimum(lo_t, hi_t), torch.maximum(lo_t, hi_t)
            w = b - a
            t_new = _cubic_min(lo_t, lo_f, lo_gtd, hi_t, hi[1], hi[2],
                               a + 0.1 * w, b - 0.1 * w)
            f_new, g_new = vg(x + t_new * d)
            gtd_new = torch.dot(g_new, d)
            nev += 1
            if bool(w <= 1e-9 * torch.clamp_min(b, 1.0)):
                t, f, g = lo_t, lo_f, lo_g         # degenerate bracket
                stage = _DONE
            elif bool((f_new > f0 + c1 * t_new * gtd0) | (f_new >= lo_f)):
                hi = (t_new, f_new, gtd_new, g_new)
            elif bool(torch.abs(gtd_new) <= -c2 * gtd0):
                t, f, g = t_new, f_new, g_new
                stage = _DONE
            else:
                if bool(gtd_new * (hi_t - lo_t) >= 0.0):
                    hi = lo
                lo = (t_new, f_new, gtd_new, g_new)
            it += 1
            continue
        gtd_t = torch.dot(g, d)
        if bool((f > f0 + c1 * t * gtd0) | ((it > 0) & (f >= fp))):
            lo, hi = (tp, fp, gtdp, gp), (t, f, gtd_t, g)
            stage = _ZOOM
        elif bool(torch.abs(gtd_t) <= -c2 * gtd0):
            stage = _DONE
        elif bool(gtd_t >= 0.0):
            lo, hi = (t, f, gtd_t, g), (tp, fp, gtdp, gp)
            stage = _ZOOM
        else:                                      # extrapolate
            t_new = _cubic_min(tp, fp, gtdp, t, f, gtd_t,
                               t + 0.01 * (t - tp), t * 10.0)
            f_new, g_new = vg(x + t_new * d)
            tp, fp, gtdp, gp = t, f, gtd_t, g
            t, f, g = t_new, f_new, g_new
            nev += 1
        it += 1
    if stage == _ZOOM:
        t, f, g = lo[0], lo[1], lo[3]
    elif stage == _BRACKET and bool(f > f0 + c1 * t * gtd0):
        t, f, g = tp, fp, gp
    return t, f, g, nev


class LBFGS:
    """minimize(feval, x0) → (x*, final_loss, n_iter); `.evals` is the
    number of feval evaluations of the last minimize."""

    def __init__(self, max_iter: int = 100, history_size: int = 10,
                 learningrate: float = 1.0, tolfun: float = 1e-8,
                 tolx: float = 1e-9,
                 line_search: Union[bool, str] = "wolfe",
                 ls_max_steps: int = 25, armijo_c: float = 1e-4,
                 ls_backtrack: float = 0.5, wolfe_c2: float = 0.9):
        """line_search: "wolfe" (the reference's lswolfe; True means
        it too), "armijo" (backtracking sufficient decrease only) or
        False (a fixed step of `learningrate`)."""
        self.max_iter = max_iter
        self.history_size = history_size
        self.learningrate = learningrate
        self.tolfun = tolfun
        self.tolx = tolx
        if line_search is True:
            line_search = "wolfe"
        if line_search not in ("wolfe", "armijo", False):
            raise ValueError(f"unknown line_search {line_search!r}")
        self.line_search = line_search
        self.ls_max_steps = ls_max_steps
        self.armijo_c = armijo_c
        self.ls_backtrack = ls_backtrack
        self.wolfe_c2 = wolfe_c2
        self.evals: Optional[int] = None

    def _search(self, vg, x, fx, g, d):
        """(t, f, g, evaluations) along d."""
        gtd = torch.dot(g, d)
        t0 = torch.tensor(self.learningrate, dtype=x.dtype, device=x.device)
        if not self.line_search:
            fx2, g2 = vg(x + t0 * d)
            return t0, fx2, g2, 1
        if self.line_search == "wolfe":
            return _strong_wolfe(vg, x, t0, d, fx, g, gtd, self.armijo_c,
                                 self.wolfe_c2, self.ls_max_steps)
        t, k = t0, 0
        fx2, g2 = vg(x + t * d)
        while k < self.ls_max_steps and bool(
                fx2 > fx + self.armijo_c * t * gtd):
            t = t * self.ls_backtrack
            fx2, g2 = vg(x + t * d)
            k += 1
        return t, fx2, g2, k + 1

    def minimize(self, feval: Callable[[Any], torch.Tensor], x0: Any
                 ) -> Tuple[Any, torch.Tensor, int]:
        leaves = tree_leaves(x0)
        flat0 = torch.cat([t.detach().reshape(-1) for t in leaves])
        sizes = [t.numel() for t in leaves]
        shapes = [t.shape for t in leaves]

        def unravel(flat):
            pieces = torch.split(flat, sizes)
            return tree_unflatten(x0, [p.view(s)
                                       for p, s in zip(pieces, shapes)])

        def vg(flat):
            with torch.enable_grad():
                x = flat.detach().requires_grad_()
                loss = feval(unravel(x))
                (grad,) = torch.autograd.grad(loss, x)
            return loss.detach(), grad

        m, n = self.history_size, flat0.numel()
        s_hist = flat0.new_zeros((m, n))
        y_hist = flat0.new_zeros((m, n))
        rho = flat0.new_zeros((m,))
        count = head = it = 0
        x = flat0
        fx, g = vg(x)
        nev = 1
        converged = False
        while it < self.max_iter and not converged:
            d = self._direction(g, s_hist, y_hist, rho, count, head)
            if not bool(torch.dot(g, d) < 0):
                d = -g               # not a descent direction
            t, fx2, g2, k = self._search(vg, x, fx, g, d)
            nev += k
            s = t * d
            y = g2 - g
            sy = torch.dot(s, y)
            if bool(sy > 1e-10):     # curvature check before admitting
                s_hist[head] = s
                y_hist[head] = y
                rho[head] = 1.0 / torch.clamp_min(sy, 1e-10)
                head = (head + 1) % m
                count = min(count + 1, m)
            converged = bool((torch.abs(fx2 - fx) < self.tolfun)
                             | (torch.max(torch.abs(s)) < self.tolx)
                             | (torch.max(torch.abs(g2)) < self.tolfun))
            x, fx, g = x + s, fx2, g2
            it += 1
        self.evals = nev
        return unravel(x), fx, it

    @staticmethod
    def _direction(g, s_hist, y_hist, rho, count, head):
        """Two-loop recursion over the `count` newest pairs of the ring
        (reference: LBFGS.scala twoLoop)."""
        m = s_hist.shape[0]
        q = -g
        alphas = {}
        for i in range(count):                 # newest to oldest
            j = (head - 1 - i) % m
            alphas[j] = rho[j] * torch.dot(s_hist[j], q)
            q = q - alphas[j] * y_hist[j]
        if count > 0:                          # γ = s.y / y.y, newest
            jn = (head - 1) % m
            q = q * (torch.dot(s_hist[jn], y_hist[jn]) / torch.clamp_min(
                torch.dot(y_hist[jn], y_hist[jn]), 1e-10))
        for i in range(count):                 # oldest to newest
            j = (head - count + i) % m
            beta = rho[j] * torch.dot(y_hist[j], q)
            q = q + (alphas[j] - beta) * s_hist[j]
        return q
