"""Solvers over a batch of independent problems: the shared machinery
and batched L-BFGS (the port of the reference's ``jax.vmap`` of its
solvers over a bucket of entities, ``random_effect.py:1325-1352``).

Every solver here minimizes ``fun(W) -> (F [B], G [B, S])`` from
``W0 [B, S]``, B problems at once. Under ``jax.vmap`` a ``while_loop``
runs its body while any lane's condition holds, and a lane whose
condition is false keeps its state; that holds at every level of
nesting (the outer iteration, the line search, TRON's CG). So each
problem's iterates, iteration count and convergence reason are those a
solo solve gives. The solvers here keep exactly that: every branch is a
``torch.where`` on per-problem masks, a lane that has stopped keeps its
state, and each loop level is a ``utils.device_loop`` loop: eagerly it
asks the device once per step whether any lane still runs (those
questions are the solvers' host syncs, counted in ``host_syncs``);
inside a CUDA-graph capture (the fused fit) it is a WHILE node, and
nothing is asked. ``torch.func.vmap`` cannot express the loops (no
data-dependent control flow), so the batch axis is explicit.

``single`` runs one problem through a batched solver as a batch of one:
the fixed effect's OWL-QN, TRON and L-BFGS-B are these solvers with
B = 1, and so is its L-BFGS in the fused fit; the unfused loop's
L-BFGS stays ``lbfgs.py`` (host branching).

Constants and the convergence cascade are the reference's
(``photon_tpu/optim/lbfgs.py``, ``base.py``).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from photon_tpu_torch.optim.base import (
    OptimizerConfig,
    OptResult,
    Tolerances,
    absolute_tolerances,
    across_shards,
    convergence_code,
    l2norm,
)
from photon_tpu_torch.utils import device_loop

_C1 = 1e-4  # Armijo sufficient decrease
_C2 = 0.9  # strong-Wolfe curvature
_BACKTRACK = 0.5
_CURVATURE_EPS = 1e-10

# "Is any lane still running?" device-to-host copies, all loop levels.
host_syncs = 0


def any_running(mask: torch.Tensor) -> bool:
    """One host sync: whether any lane of ``mask`` is set."""
    global host_syncs
    host_syncs += 1
    return bool(mask.any())


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return across_shards(torch.sum(a * b, dim=-1))[0]


def sel(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """``new`` on the lanes of ``mask`` [B], ``old`` elsewhere."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


class History:
    """Per-lane (s, y) rings [B, m, S] with ``rho`` [B, m] (0 marks an
    empty or skipped slot) and ``count`` [B] accepted pairs."""

    def __init__(self, b: int, m: int, s: int, dtype, device):
        self.s = torch.zeros((b, m, s), dtype=dtype, device=device)
        self.y = torch.zeros((b, m, s), dtype=dtype, device=device)
        self.rho = torch.zeros((b, m), dtype=dtype, device=device)
        self.count = torch.zeros(b, dtype=torch.int64, device=device)
        self.lanes = torch.arange(b, device=device)

    @property
    def m(self) -> int:
        return self.rho.shape[1]

    def direction(self, g: torch.Tensor) -> torch.Tensor:
        """d = -H g by the two-loop recursion over each lane's ring
        (the reference's ``_two_loop_direction``)."""
        m, k, ar = self.m, self.count, self.lanes
        q = g
        alphas = torch.zeros_like(self.rho)
        for j in range(m):
            idx = (k - 1 - j) % m
            rho = self.rho[ar, idx]
            valid = (j < k) & (rho != 0.0)
            a = torch.where(valid, rho * dot(self.s[ar, idx], q), 0.0)
            q = q - a[:, None] * self.y[ar, idx]
            alphas[ar, idx] = a
        newest = (k - 1) % m
        y_new = self.y[ar, newest]
        yy = dot(y_new, y_new)
        rho_new = self.rho[ar, newest]
        tiny = torch.finfo(g.dtype).tiny
        gamma = torch.where(
            (k > 0) & (rho_new != 0.0) & (yy > 0.0),
            1.0 / torch.clamp(rho_new * yy, min=tiny), 1.0)
        r = gamma[:, None] * q
        nvalid = torch.clamp(k, max=m)
        for j in range(m):
            idx = (k - nvalid + j) % m
            rho = self.rho[ar, idx]
            valid = (j < nvalid) & (rho != 0.0)
            beta = torch.where(valid, rho * dot(self.y[ar, idx], r), 0.0)
            r = r + (alphas[ar, idx] - beta)[:, None] * self.s[ar, idx]
        return -r

    def push(self, s: torch.Tensor, y: torch.Tensor,
             take: torch.Tensor) -> None:
        """Append (s, y) on the lanes of ``take`` whose curvature s.y is
        sufficiently positive (the reference's ``_push_history`` under
        its accept select)."""
        sy = dot(s, y)
        ok = take & (sy > _CURVATURE_EPS * l2norm(s) * l2norm(y))
        ar, idx = self.lanes, self.count % self.m
        rho = 1.0 / torch.where(ok, sy, torch.ones_like(sy))
        self.s[ar, idx] = sel(ok, s, self.s[ar, idx])
        self.y[ar, idx] = sel(ok, y, self.y[ar, idx])
        self.rho[ar, idx] = torch.where(ok, rho, self.rho[ar, idx])
        self.count = self.count + ok.long()


def first_step(hist: History, g: torch.Tensor) -> torch.Tensor:
    """Initial probe: min(1, 1/|g|) before any curvature pair, else 1."""
    one = torch.ones_like(g[..., 0])
    return torch.where(hist.count == 0,
                       torch.minimum(one, 1.0 / torch.clamp(l2norm(g),
                                                            min=1e-12)),
                       one)


def descent_guard(g: torch.Tensor, d: torch.Tensor):
    """(d, g.d), with d replaced by -g where it is no descent direction."""
    dderiv = dot(g, d)
    bad = dderiv >= 0.0
    return sel(bad, -g, d), torch.where(bad, -dot(g, g), dderiv)


def wolfe_line_search(fun, w, f0, g0, d, dderiv, t0, max_iters: int,
                      active: torch.Tensor):
    """Strong-Wolfe search with bisection zoom per lane (the reference's
    ``_wolfe_line_search``). Returns (t, f_t, g_t, improved)."""
    c = SimpleNamespace(
        t=t0, f_t=f0, g_t=g0, t_lo=torch.zeros_like(t0), f_lo=f0,
        t_hi=torch.zeros_like(t0), bracketed=torch.zeros_like(active),
        done=torch.zeros_like(active),
        it=torch.zeros(t0.shape, dtype=torch.int64, device=t0.device))

    def body(run):
        tp = torch.where(c.bracketed, 0.5 * (c.t_lo + c.t_hi), c.t)
        fp, gp = fun(w + tp[:, None] * d)
        dphi = dot(gp, d)
        armijo = fp <= f0 + _C1 * tp * dderiv
        curv = torch.abs(dphi) <= -_C2 * dderiv
        shrink = ~armijo | (c.bracketed & (fp >= c.f_lo))
        accept = armijo & curv
        flip = torch.where(c.bracketed, dphi * (c.t_hi - c.t_lo) >= 0,
                           dphi >= 0)
        pos_slope = armijo & ~curv & flip
        br_new = c.bracketed | shrink | pos_slope
        lo_up = run & armijo & ~shrink
        c.t_hi = torch.where(run, torch.where(
            shrink, tp, torch.where(pos_slope, c.t_lo, c.t_hi)), c.t_hi)
        c.t_lo = torch.where(lo_up, tp, c.t_lo)
        c.f_lo = torch.where(lo_up, fp, c.f_lo)
        t_next = torch.where(accept | br_new, tp, tp * 2.0)
        c.t = torch.where(run, t_next, c.t)
        c.f_t = torch.where(run, fp, c.f_t)
        c.g_t = sel(run, gp, c.g_t)
        c.bracketed = torch.where(run, br_new, c.bracketed)
        c.done = torch.where(run, accept, c.done)
        c.it = c.it + run.long()

    device_loop.while_loop(
        lambda: active & ~c.done & (c.it < max_iters), body, (c,),
        any_running=any_running)
    ok = c.done | (c.t_lo > 0)
    c.t = torch.where(c.done, c.t, c.t_lo)

    # Exhausted lanes fall back to the best Armijo point t_lo.
    def fallback():
        fb, gb = fun(w + c.t[:, None] * d)
        c.f_t = torch.where(c.done, c.f_t, fb)
        c.g_t = sel(c.done, c.g_t, gb)

    device_loop.cond_apply(active & ~c.done, fallback, (c,),
                           any_running=any_running)
    return c.t, c.f_t, c.g_t, ok & (c.f_t < f0)


class Solve:
    """The per-lane state shared by the solvers' outer loops."""

    def __init__(self, w, f, g, config: OptimizerConfig, tol: Tolerances,
                 history: bool):
        b = w.shape[0]
        dev = w.device
        self.w, self.f, self.g, self.tol = w, f, g, tol
        self.max_iterations = config.max_iterations
        self.iteration = torch.zeros(b, dtype=torch.int64, device=dev)
        self.code = torch.zeros(b, dtype=torch.int32, device=dev)
        self.losses = (f[:, None].repeat(1, config.max_iterations + 1)
                       if history else None)

    def loop(self, body, *state) -> None:
        """Run ``body(active)`` while any lane is still running, with
        this state and ``state`` as the carry (``device_loop``)."""
        device_loop.while_loop(lambda: self.code == 0, body,
                               (self, *state), any_running=any_running)

    def commit(self, active, w, f, g, code, iteration) -> None:
        self.w = sel(active, w, self.w)
        self.f = torch.where(active, f, self.f)
        self.g = sel(active, g, self.g)
        self.iteration = torch.where(active, iteration, self.iteration)
        self.code = torch.where(active, code, self.code)
        if self.losses is not None:
            ar = torch.arange(w.shape[0], device=w.device)
            at = self.iteration.clamp(max=self.max_iterations)
            self.losses[ar, at] = torch.where(active, self.f,
                                              self.losses[ar, at])

    def result(self, gradient_norm: torch.Tensor) -> OptResult:
        return OptResult(self.w, self.f, gradient_norm,
                         self.iteration.to(torch.int32), self.code,
                         self.losses)


def lbfgs(fun, w0: torch.Tensor, config: OptimizerConfig | None = None, *,
          tolerances: Tolerances | None = None,
          history: bool = False) -> OptResult:
    """Batched L-BFGS (the reference's ``lbfgs_solve`` under vmap); box
    constraints go to ``lbfgsb.lbfgsb``."""
    config = config or OptimizerConfig()
    if config.box_constraints is not None:
        from photon_tpu_torch.optim import lbfgsb

        return lbfgsb.lbfgsb(fun, w0, config, tolerances=tolerances,
                             history=history)
    tol = tolerances if tolerances is not None else absolute_tolerances(
        fun, w0, config.tolerance)
    f0, g0 = fun(w0)
    st = Solve(w0, f0, g0, config, tol, history)
    hist = History(w0.shape[0], config.num_corrections, w0.shape[1],
                   w0.dtype, w0.device)

    def body(active):
        w, f, g = st.w, st.f, st.g
        d, dderiv = descent_guard(g, hist.direction(g))
        t, f_new, g_new, improved = wolfe_line_search(
            fun, w, f, g, d, dderiv, first_step(hist, g),
            config.max_line_search_iterations, active)
        accept = improved & (f_new < f)
        w_acc = sel(accept, w + t[:, None] * d, w)
        f_acc = torch.where(accept, f_new, f)
        g_acc = sel(accept, g_new, g)
        hist.push(w_acc - w, g_acc - g, active & accept)
        iteration = st.iteration + accept.long()
        code = convergence_code(
            iteration=iteration, max_iterations=config.max_iterations,
            loss_delta=f - f_acc, gradient_norm=l2norm(g_acc), tol=tol,
            not_improving=~accept)
        st.commit(active, w_acc, f_acc, g_acc, code, iteration)

    st.loop(body, hist)
    return st.result(l2norm(st.g))


def single(solver, fun, w0: torch.Tensor, *args, hvp=None,
           tolerances: Tolerances | None = None, **kw) -> OptResult:
    """One problem ``fun(w) -> (f, g)`` through a batched solver as a
    batch of one; the result has the problem's own shapes."""

    def fun_b(w):
        f, g = fun(w[0])
        return f.reshape(1), g.reshape(1, -1)

    if hvp is not None:
        kw["hvp"] = lambda w, v: hvp(w[0], v[0]).reshape(1, -1)
    if tolerances is not None:
        tolerances = Tolerances(tolerances.loss_abs.reshape(1),
                                tolerances.gradient_abs.reshape(1))
    r = solver(fun_b, w0[None], *args, tolerances=tolerances,
               history=True, **kw)
    return OptResult(r.coefficients[0], r.value[0], r.gradient_norm[0],
                     r.iterations[0], r.convergence_reason[0],
                     r.loss_history[0])
