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

import torch

from photon_tpu_torch.optim import batched
from photon_tpu_torch.optim.base import (
    OptimizerConfig,
    OptResult,
    Tolerances,
    absolute_tolerances,
    convergence_code,
    l2norm,
)


def _bounds(config: OptimizerConfig, like: torch.Tensor):
    if config.box_constraints is None:
        raise ValueError("L-BFGS-B requires config.box_constraints")
    lower, upper = config.box_constraints
    return (torch.as_tensor(lower, dtype=like.dtype, device=like.device),
            torch.as_tensor(upper, dtype=like.dtype, device=like.device))


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
    while (active := st.running()) is not None:
        w, f, g = st.w, st.f, st.g
        free = ~(((w <= lower) & (g > 0)) | ((w >= upper) & (g < 0)))
        g_free = torch.where(free, g, 0.0)
        d = torch.where(free, hist.direction(g_free), 0.0)
        d, _ = batched.descent_guard(g_free, d)
        t = batched.first_step(hist, g_free)
        w_t, f_t, g_t = w, f, g
        done = torch.zeros_like(active)
        it = 0
        while True:
            run = active & ~done & (it < config.max_line_search_iterations)
            if not batched.any_running(run):
                break
            wp = torch.clamp(w + t[:, None] * d, lower, upper)
            fp, gp = fun(wp)
            ok = fp <= f + batched._C1 * batched.dot(g, wp - w)
            t = torch.where(run & ~ok, t * batched._BACKTRACK, t)
            w_t = batched.sel(run, wp, w_t)
            f_t = torch.where(run, fp, f_t)
            g_t = batched.sel(run, gp, g_t)
            done = torch.where(run, ok, done)
            it += 1
        improved = done & (f_t < f)
        hist.push(w_t - w, g_t - g, active & improved)
        w_acc = batched.sel(improved, w_t, w)
        f_acc = torch.where(improved, f_t, f)
        g_acc = batched.sel(improved, g_t, g)
        iteration = st.iteration + 1
        code = convergence_code(
            iteration=iteration, max_iterations=config.max_iterations,
            loss_delta=f - f_acc,
            gradient_norm=l2norm(_projected_gradient(w_acc, g_acc, lower,
                                                     upper)),
            tol=tol, not_improving=~improved)
        st.commit(active, w_acc, f_acc, g_acc, code, iteration)
    return st.result(l2norm(_projected_gradient(st.w, st.g, lower, upper)))


def lbfgsb_solve(fun, w0: torch.Tensor,
                 config: OptimizerConfig | None = None, *,
                 tolerances: Tolerances | None = None) -> OptResult:
    """Minimize ``fun(w) -> (value, grad)`` subject to
    ``config.box_constraints`` (one problem)."""
    return batched.single(lbfgsb, fun, w0, config or OptimizerConfig(),
                          tolerances=tolerances)
