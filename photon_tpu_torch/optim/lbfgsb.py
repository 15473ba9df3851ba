"""Bound-constrained L-BFGS (port of ``photon_tpu/optim/lbfgsb.py``, the
reference's LBFGSB.scala:39-92): a gradient-projection active-set
method, batched over problems as ``batched.py`` describes.

Per iteration: the active set (at a bound with the gradient pushing
outward), the two-loop direction of the free gradient masked to the
free subspace, and a projected Armijo backtracking along the bent path
P(w + t d) with the Bertsekas decrease test f(w(t)) <= f + c1 g.(w(t) -
w). Convergence uses the projected-gradient norm ||P(w - g) - w||, zero
exactly at KKT points. Every iteration counts, accepted or not.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from photon_tpu_torch.optim import batched
from photon_tpu_torch.optim.base import (
    OptimizerConfig,
    OptResult,
    Tolerances,
    absolute_tolerances,
    box_bounds,
    convergence_code,
    l2norm,
)
from photon_tpu_torch.utils import device_loop


def _bounds(config: OptimizerConfig, like: torch.Tensor):
    if config.box_constraints is None:
        raise ValueError("L-BFGS-B requires config.box_constraints")
    return box_bounds(config.box_constraints, like)


def _projected_gradient(w, g, lower, upper):
    """P(w - g) - w: zero exactly at KKT points of the box problem."""
    return torch.clamp(w - g, lower, upper) - w


def lbfgsb(fun, w0: torch.Tensor, config: OptimizerConfig, *,
           tolerances: Tolerances | None = None,
           history: bool = False) -> OptResult:
    """Batched: minimize ``fun(W) -> (F [B], G [B, S])`` subject to
    ``config.box_constraints``."""
    lower, upper = _bounds(config, w0)
    tol = tolerances if tolerances is not None else absolute_tolerances(
        fun, w0, config.tolerance)
    w0 = torch.clamp(w0, lower, upper)
    f0, g0 = fun(w0)
    st = batched.Solve(w0, f0, g0, config, tol, history)
    hist = batched.History(w0.shape[0], config.num_corrections,
                           w0.shape[1], w0.dtype, w0.device)
    def body(active):
        w, f, g = st.w, st.f, st.g
        free = ~(((w <= lower) & (g > 0)) | ((w >= upper) & (g < 0)))
        g_free = torch.where(free, g, 0.0)
        d = torch.where(free, hist.direction(g_free), 0.0)
        d, _ = batched.descent_guard(g_free, d)
        ls = SimpleNamespace(
            t=batched.first_step(hist, g_free), w_t=w, f_t=f, g_t=g,
            done=torch.zeros_like(active),
            it=torch.zeros((), dtype=torch.int64, device=w.device))

        def search(run):
            wp = torch.clamp(w + ls.t[:, None] * d, lower, upper)
            fp, gp = fun(wp)
            ok = fp <= f + batched._C1 * batched.dot(g, wp - w)
            ls.t = torch.where(run & ~ok, ls.t * batched._BACKTRACK, ls.t)
            ls.w_t = batched.sel(run, wp, ls.w_t)
            ls.f_t = torch.where(run, fp, ls.f_t)
            ls.g_t = batched.sel(run, gp, ls.g_t)
            ls.done = torch.where(run, ok, ls.done)
            ls.it = ls.it + 1

        device_loop.while_loop(
            lambda: (active & ~ls.done
                     & (ls.it < config.max_line_search_iterations)),
            search, (ls,), any_running=batched.any_running)
        improved = ls.done & (ls.f_t < f)
        hist.push(ls.w_t - w, ls.g_t - g, active & improved)
        w_acc = batched.sel(improved, ls.w_t, w)
        f_acc = torch.where(improved, ls.f_t, f)
        g_acc = batched.sel(improved, ls.g_t, g)
        iteration = st.iteration + 1
        code = convergence_code(
            iteration=iteration, max_iterations=config.max_iterations,
            loss_delta=f - f_acc,
            gradient_norm=l2norm(_projected_gradient(w_acc, g_acc, lower,
                                                     upper)),
            tol=tol, not_improving=~improved)
        st.commit(active, w_acc, f_acc, g_acc, code, iteration)

    st.loop(body, hist)
    return st.result(l2norm(_projected_gradient(st.w, st.g, lower, upper)))


def lbfgsb_solve(fun, w0: torch.Tensor,
                 config: OptimizerConfig | None = None, *,
                 tolerances: Tolerances | None = None) -> OptResult:
    """Minimize ``fun(w) -> (value, grad)`` subject to
    ``config.box_constraints`` (one problem)."""
    return batched.single(lbfgsb, fun, w0, config or OptimizerConfig(),
                          tolerances=tolerances)
