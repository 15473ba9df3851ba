"""L-BFGS with the two-loop recursion and a strong-Wolfe line search
(port of ``photon_tpu/optim/lbfgs.py``).

The vectors (iterate, gradient, the (s, y) history) stay on the device;
the control flow runs on the host. Every scalar the loop branches on is
copied to the host as a numpy scalar of the data's dtype, so each
comparison and each step-size update is the same IEEE operation the JAX
solver performs inside its ``while_loop``. Those copies are the solver's
host syncs: one per line-search probe and two per iteration, counted in
``host_syncs``.

The history keeps the last ``num_corrections`` accepted pairs whose
curvature ``s.y`` is sufficiently positive (LBFGS.scala:148-154).

On a column-sharded fixed effect (``base.sharded_over``) the vectors are
this rank's slices: each inner product is summed over the ranks, and
the scalars an iteration fetches together cross in one collective.
"""

from __future__ import annotations

import numpy as np
import torch

from photon_tpu_torch.optim.base import (
    OptimizerConfig,
    OptResult,
    Tolerances,
    absolute_tolerances,
    across_shards,
    convergence_code,
    dot,
    l2norm,
)

_C1 = 1e-4  # Armijo sufficient decrease
_C2 = 0.9  # strong-Wolfe curvature
_CURVATURE_EPS = 1e-10

# Device-to-host copies made by the solver (each one waits for the card).
host_syncs = 0


def _host(*values: torch.Tensor) -> list:
    """One device-to-host copy of several scalars, as numpy scalars of
    their dtype."""
    global host_syncs
    host_syncs += 1
    arr = torch.stack([v.reshape(()) for v in values]).cpu().numpy()
    return list(arr)


class _History:
    """Ring of (s, y) pairs; ``rho`` and ``yy`` are host scalars."""

    def __init__(self, m: int):
        self.m = m
        self.s: list = [None] * m
        self.y: list = [None] * m
        self.rho: list = [None] * m
        self.yy: list = [None] * m
        self.count = 0

    def push(self, s, y, rho, yy) -> None:
        idx = self.count % self.m
        self.s[idx], self.y[idx] = s, y
        self.rho[idx], self.yy[idx] = rho, yy
        self.count += 1

    def direction(self, g: torch.Tensor) -> torch.Tensor:
        """d = -H g by the two-loop recursion over the valid pairs."""
        m, k = self.m, self.count
        nvalid = min(k, m)
        q = g
        alphas: dict[int, torch.Tensor] = {}
        for j in range(nvalid):
            idx = (k - 1 - j) % m
            a = dot(self.s[idx], q) * self.rho[idx]
            q = q - a * self.y[idx]
            alphas[idx] = a
        gamma = None
        if k > 0:
            newest = (k - 1) % m
            yy = self.yy[newest]
            if yy > 0:
                tiny = np.finfo(yy.dtype).tiny
                gamma = yy.dtype.type(1.0) / max(self.rho[newest] * yy, tiny)
        r = q if gamma is None else q * gamma
        for j in range(nvalid):
            idx = (k - nvalid + j) % m
            beta = dot(self.y[idx], r) * self.rho[idx]
            r = r + (alphas[idx] - beta) * self.s[idx]
        return -r


def _wolfe_line_search(fun, w, f0, g0, d, dderiv, t0, max_iters):
    """Strong-Wolfe search with bisection zoom (Nocedal-Wright 3.5/3.6).
    Returns (t, f_t, g_t, improved); ``improved`` certifies Armijo and a
    lower objective than ``f0``."""
    dt = type(f0)
    t, f_t, g_t = t0, f0, g0
    t_lo, f_lo, t_hi = dt(0.0), f0, dt(0.0)
    bracketed = done = False
    it = 0
    while not done and it < max_iters:
        if bracketed:
            t = dt(0.5) * (t_lo + t_hi)
        f_dev, g_t = fun(w + d * t)
        f_t, dphi = _host(f_dev, dot(g_t, d))
        armijo = f_t <= f0 + _C1 * t * dderiv
        curv = abs(dphi) <= -_C2 * dderiv
        shrink = (not armijo) or (bracketed and f_t >= f_lo)
        accept = armijo and curv
        flip = (dphi * (t_hi - t_lo) >= 0) if bracketed else (dphi >= 0)
        pos_slope = armijo and not curv and flip
        new_bracketed = bracketed or shrink or pos_slope
        if shrink:
            t_hi = t
        elif pos_slope:
            t_hi = t_lo
        if armijo and not shrink:
            t_lo, f_lo = t, f_t
        if not accept and not new_bracketed:
            t = t * dt(2.0)
        bracketed = new_bracketed
        done = accept
        it += 1
    ok = done or t_lo > 0
    if not done:
        t = t_lo
        f_dev, g_t = fun(w + d * t)
        (f_t,) = _host(f_dev)
    return t, f_t, g_t, bool(ok and f_t < f0)


def lbfgs_solve(fun, w0: torch.Tensor, config: OptimizerConfig | None = None,
                *, tolerances: Tolerances | None = None) -> OptResult:
    """Minimize ``fun(w) -> (value, grad)`` from ``w0``; box
    constraints go to the bound-constrained solver (``lbfgsb.py``), as
    the reference's ``lbfgs_solve`` routes them."""
    config = config or OptimizerConfig()
    if config.box_constraints is not None:
        from photon_tpu_torch.optim.lbfgsb import lbfgsb_solve

        return lbfgsb_solve(fun, w0, config, tolerances=tolerances)
    dtype = w0.dtype
    tol = tolerances if tolerances is not None else absolute_tolerances(
        fun, w0, config.tolerance)
    loss_abs, grad_abs = _host(tol.loss_abs, tol.gradient_abs)
    dt = type(loss_abs)

    w = w0
    f_dev, g = fun(w0)
    (f,) = _host(f_dev)
    losses = [f] * (config.max_iterations + 1)
    hist = _History(config.num_corrections)
    iteration, code = 0, 0
    while code == 0:
        direction = hist.direction(g)
        gd, gg, gsq = across_shards(torch.dot(g, direction),
                                    torch.dot(g, g), torch.sum(g * g, dim=-1))
        dderiv, gg, gnorm = _host(gd, gg, torch.sqrt(gsq))
        if dderiv >= 0:
            direction, dderiv = -g, -gg
        t0 = dt(1.0)
        if hist.count == 0:
            t0 = min(dt(1.0), dt(1.0) / max(gnorm, dt(1e-12)))
        t, f_new, g_new, improved = _wolfe_line_search(
            fun, w, f, g, direction, dderiv, t0,
            config.max_line_search_iterations)
        accept = improved and f_new < f
        if accept:
            w_acc = w + direction * t
            s, y = w_acc - w, g_new - g
            sums = across_shards(
                torch.dot(s, y), torch.sum(s * s, dim=-1),
                torch.sum(y * y, dim=-1), torch.dot(y, y),
                torch.sum(g_new * g_new, dim=-1))
            sy, sn, yn, yy, gn = _host(
                sums[0], torch.sqrt(sums[1]), torch.sqrt(sums[2]), sums[3],
                torch.sqrt(sums[4]))
            if sy > _CURVATURE_EPS * sn * yn:
                hist.push(s, y, dt(1.0) / sy, yy)
            f_acc, g_acc = f_new, g_new
            iteration += 1
        else:
            w_acc, f_acc, g_acc = w, f, g
            (gn,) = _host(l2norm(g))
        code = int(convergence_code(
            iteration=torch.tensor(iteration),
            max_iterations=config.max_iterations,
            loss_delta=torch.tensor(f - f_acc),
            gradient_norm=torch.tensor(gn),
            tol=Tolerances(torch.tensor(loss_abs), torch.tensor(grad_abs)),
            not_improving=torch.tensor(not accept),
        ))
        losses[iteration] = f_acc
        w, f, g = w_acc, f_acc, g_acc
    dev = w0.device
    return OptResult(
        coefficients=w,
        value=torch.tensor(f, dtype=dtype, device=dev),
        gradient_norm=l2norm(g),
        iterations=torch.tensor(iteration, dtype=torch.int32, device=dev),
        convergence_reason=torch.tensor(code, dtype=torch.int32, device=dev),
        loss_history=torch.tensor(np.asarray(losses), dtype=dtype,
                                  device=dev),
    )
