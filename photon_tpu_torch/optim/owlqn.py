"""OWL-QN for L1 and elastic net (port of ``photon_tpu/optim/owlqn.py``,
the reference's OWLQN.scala:39-83; Andrew & Gao 2007), batched over
problems as ``batched.py`` describes.

F(w) = f(w) + l1 |w|_1 with a uniform L1 weight, the intercept
included (Breeze's OWLQN as the reference calls it). The minimum-norm
subgradient is the pseudo-gradient; the two-loop direction of it is
kept where it agrees in sign with steepest descent, and each line
search probe is projected onto the orthant of the current point (a
coordinate that would cross zero is set to exactly 0). The history
takes smooth-gradient differences. Absolute tolerances come from the
zero state of F: |f(0)| and the pseudo-gradient's norm at 0.

On a column-sharded fixed effect (``base.sharded_over``) the
pseudo-gradient, the orthant and the projection are elementwise on this
rank's slice; the L1 term of F is summed over the ranks inside the
objective's own sum of inner products (``base.across_shards_later``),
so it adds no collective. The padded slots get no data gradient, so
they stay at 0.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from photon_tpu_torch.optim import batched
from photon_tpu_torch.optim.base import (
    OptimizerConfig,
    OptResult,
    Tolerances,
    across_shards_later,
    convergence_code,
    l2norm,
)
from photon_tpu_torch.utils import device_loop


def _pseudo_gradient(w, g, l1):
    """Minimum-norm subgradient of f(w) + l1 |w|_1."""
    right = g + l1
    left = g - l1
    at_zero = torch.where(right < 0.0, right,
                          torch.where(left > 0.0, left, 0.0))
    return torch.where(w > 0.0, right, torch.where(w < 0.0, left, at_zero))


def owlqn(fun, w0: torch.Tensor, l1_weight, config: OptimizerConfig, *,
          tolerances: Tolerances | None = None,
          history: bool = False) -> OptResult:
    """Batched: minimize f(W) + l1 |W|_1 where ``fun`` evaluates the
    smooth part; ``l1_weight`` a scalar or broadcastable to W."""
    l1 = torch.as_tensor(l1_weight, dtype=w0.dtype, device=w0.device)

    def total(w):
        # On a column shard the L1 partial rides in the first sum over
        # the ranks that ``fun`` makes (the L2 or prior term's).
        pen = across_shards_later(torch.sum(l1 * torch.abs(w), dim=-1))
        f, g = fun(w)
        return f + pen(), g

    if tolerances is None:
        zero = torch.zeros_like(w0)
        f0z, g0z = fun(zero)
        tolerances = Tolerances(
            torch.abs(f0z) * config.tolerance,
            l2norm(_pseudo_gradient(zero, g0z, l1)) * config.tolerance)
    f0, g0 = total(w0)
    st = batched.Solve(w0, f0, g0, config, tolerances, history)
    hist = batched.History(w0.shape[0], config.num_corrections,
                           w0.shape[1], w0.dtype, w0.device)
    def body(active):
        w, f, g = st.w, st.f, st.g
        pg = _pseudo_gradient(w, g, l1)
        d = hist.direction(pg)
        d = torch.where(d * pg < 0.0, d, 0.0)
        d, dderiv = batched.descent_guard(pg, d)
        orthant = torch.where(w != 0.0, torch.sign(w), torch.sign(-pg))

        def project(t):
            w_t = w + t[:, None] * d
            return torch.where(torch.sign(w_t) == orthant, w_t, 0.0)

        ls = SimpleNamespace(
            t=batched.first_step(hist, pg), done=torch.zeros_like(active),
            it=torch.zeros((), dtype=torch.int64, device=w.device))

        def search(run):
            fp, _ = total(project(ls.t))
            ok = fp <= f + batched._C1 * ls.t * dderiv
            ls.t = torch.where(run & ~ok, ls.t * batched._BACKTRACK, ls.t)
            ls.done = torch.where(run, ok, ls.done)
            ls.it = ls.it + 1

        device_loop.while_loop(
            lambda: (active & ~ls.done
                     & (ls.it < config.max_line_search_iterations)),
            search, (ls,), any_running=batched.any_running)
        w_new = project(ls.t)
        f_new, g_new = total(w_new)
        accept = ls.done & (f_new < f)
        w_acc = batched.sel(accept, w_new, w)
        f_acc = torch.where(accept, f_new, f)
        g_acc = batched.sel(accept, g_new, g)
        hist.push(w_acc - w, g_acc - g, active & accept)
        iteration = st.iteration + accept.long()
        code = convergence_code(
            iteration=iteration, max_iterations=config.max_iterations,
            loss_delta=f - f_acc,
            gradient_norm=l2norm(_pseudo_gradient(w_acc, g_acc, l1)),
            tol=tolerances, not_improving=~accept)
        st.commit(active, w_acc, f_acc, g_acc, code, iteration)

    st.loop(body, hist)
    return st.result(l2norm(_pseudo_gradient(st.w, st.g, l1)))


def owlqn_solve(fun, w0: torch.Tensor, l1_weight,
                config: OptimizerConfig | None = None, *,
                tolerances: Tolerances | None = None) -> OptResult:
    """Minimize f(w) + l1_weight |w|_1 (one problem)."""
    return batched.single(owlqn, fun, w0, l1_weight,
                          config or OptimizerConfig(),
                          tolerances=tolerances)
