"""TRON: trust-region Newton with a truncated-CG inner solver (port of
``photon_tpu/optim/tron.py``, the reference's LIBLINEAR port
TRON.scala:78-330), batched over problems as ``batched.py`` describes.

The reference's constants: (eta0, eta1, eta2) = (1e-4, 0.25, 0.75),
(sigma1, sigma2, sigma3) = (0.25, 0.5, 4.0); the initial radius is
||g0||, cut to the first step's length on the first trial. Each outer
step is one trial: accepted, it advances the iteration; rejected, it
counts a failure and retries with the shrunk radius, up to
``max_improvement_failures`` (then OBJECTIVE_NOT_IMPROVING). The inner
CG takes at most ``max_cg_iterations`` Hessian-vector products, stops
at a residual of 0.1 ||g||, and meets the trust-region boundary by the
quadratic formula (Lin & More eq. 13).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from photon_tpu_torch.optim import batched
from photon_tpu_torch.optim.base import (
    ConvergenceReason,
    OptimizerConfig,
    OptResult,
    Tolerances,
    absolute_tolerances,
    convergence_code,
    l2norm,
    project_box,
)
from photon_tpu_torch.utils import device_loop

_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0


def _truncated_cg(hvp, g, delta, max_cg_iterations: int, active):
    """Per lane, approximately solve min_s g.s + 0.5 s.H.s subject to
    ||s|| <= delta (TRON.truncatedConjugateGradientMethod, :272-329).
    Returns (step, residual)."""
    dot = batched.dot
    tiny = torch.finfo(g.dtype).tiny
    cg_tol = 0.1 * l2norm(g)
    c = SimpleNamespace(
        step=torch.zeros_like(g), residual=-g, direction=-g,
        rtr=dot(g, g), boundary=torch.zeros_like(active),
        it=torch.zeros((), dtype=torch.int64, device=g.device))

    def body(run):
        hd = hvp(c.direction)
        alpha = c.rtr / torch.clamp(dot(c.direction, hd), min=tiny)
        over = l2norm(c.step + alpha[:, None] * c.direction) > delta
        std = dot(c.step, c.direction)
        sts = dot(c.step, c.step)
        dtd = dot(c.direction, c.direction)
        dsq = delta * delta
        rad = torch.sqrt(torch.clamp(std * std + dtd * (dsq - sts), min=0.0))
        alpha_b = torch.where(
            std >= 0.0, (dsq - sts) / torch.clamp(std + rad, min=tiny),
            (rad - std) / torch.clamp(dtd, min=tiny))
        a = torch.where(over, alpha_b, alpha)[:, None]
        step_n = c.step + a * c.direction
        residual_n = c.residual - a * hd
        rtr_n = dot(residual_n, residual_n)
        beta = rtr_n / torch.clamp(c.rtr, min=tiny)
        direction_n = batched.sel(over, c.direction,
                                  residual_n + beta[:, None] * c.direction)
        c.step = batched.sel(run, step_n, c.step)
        c.residual = batched.sel(run, residual_n, c.residual)
        c.direction = batched.sel(run, direction_n, c.direction)
        c.rtr = torch.where(run & ~over, rtr_n, c.rtr)
        c.boundary = torch.where(run, over, c.boundary)
        c.it = c.it + 1

    device_loop.while_loop(
        lambda: (active & ~c.boundary & (l2norm(c.residual) > cg_tol)
                 & (c.it < max_cg_iterations)),
        body, (c,), any_running=batched.any_running)
    return c.step, c.residual


def tron(fun, w0: torch.Tensor, config: OptimizerConfig | None = None, *,
         hvp, tolerances: Tolerances | None = None,
         history: bool = False) -> OptResult:
    """Batched: minimize ``fun(W)`` with the Hessian-vector product
    ``hvp(W, V) -> [B, S]``."""
    config = config or OptimizerConfig.tron()
    dot = batched.dot
    tol = tolerances if tolerances is not None else absolute_tolerances(
        fun, w0, config.tolerance)
    f0, g0 = fun(w0)
    st = batched.Solve(w0, f0, g0, config, tol, history)
    c = SimpleNamespace(delta=l2norm(g0),
                        failures=torch.zeros_like(st.iteration))

    def body(active):
        delta, failures = c.delta, c.failures
        w, f, g = st.w, st.f, st.g
        step, residual = _truncated_cg(
            lambda v: hvp(w, v), g, delta, config.max_cg_iterations, active)
        w_try = w + step
        gs = dot(g, step)
        predicted = -0.5 * (gs - dot(step, residual))
        f_try, g_try = fun(w_try)
        actual = f - f_try
        step_norm = l2norm(step)
        d = torch.where(st.iteration == 0, torch.minimum(delta, step_norm),
                        delta)
        denom = f_try - f - gs
        flat = denom <= 0.0
        alpha = torch.where(
            flat, torch.full_like(denom, _SIGMA3),
            torch.clamp(-0.5 * (gs / torch.where(flat, 1.0, denom)),
                        min=_SIGMA1))
        a_sn = alpha * step_norm
        d = torch.where(
            actual < _ETA0 * predicted,
            torch.minimum(torch.clamp(alpha, min=_SIGMA1) * step_norm,
                          _SIGMA2 * d),
            torch.where(
                actual < _ETA1 * predicted,
                torch.maximum(_SIGMA1 * d, torch.minimum(a_sn, _SIGMA2 * d)),
                torch.where(
                    actual < _ETA2 * predicted,
                    torch.maximum(_SIGMA1 * d,
                                  torch.minimum(a_sn, _SIGMA3 * d)),
                    torch.maximum(d, torch.minimum(a_sn, _SIGMA3 * d)))))
        accept = actual > _ETA0 * predicted
        w_new = batched.sel(accept, project_box(w_try,
                                                config.box_constraints), w)
        f_new = torch.where(accept, f_try, f)
        g_new = batched.sel(accept, g_try, g)
        iteration = st.iteration + accept.long()
        fails = torch.where(accept, 0, failures + 1)
        code = torch.where(
            accept,
            convergence_code(iteration=iteration,
                             max_iterations=config.max_iterations,
                             loss_delta=f - f_new,
                             gradient_norm=l2norm(g_new), tol=tol),
            torch.where(fails >= config.max_improvement_failures,
                        int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING),
                        0).to(torch.int32))
        c.delta = torch.where(active, d, delta)
        c.failures = torch.where(active, fails, failures)
        st.commit(active, w_new, f_new, g_new, code, iteration)

    st.loop(body, c)
    return st.result(l2norm(st.g))


def tron_solve(fun, hvp, w0: torch.Tensor,
               config: OptimizerConfig | None = None, *,
               tolerances: Tolerances | None = None) -> OptResult:
    """Minimize ``fun(w)`` with ``hvp(w, v) = H(w) v`` (one problem)."""
    return batched.single(tron, fun, w0, config or OptimizerConfig.tron(),
                          hvp=hvp, tolerances=tolerances)
