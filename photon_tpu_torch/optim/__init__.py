"""Optimizers (port of ``photon_tpu/optim``): L-BFGS, L-BFGS-B, OWL-QN
and TRON.

``solve`` mirrors OptimizerFactory (OptimizerFactory.scala:74): L2 is
folded into the objective, a nonzero L1 weight routes to OWL-QN
whatever the configured type, a TRON config to TRON (which needs an
``hvp``), and box constraints to L-BFGS-B. ``lbfgs_solve`` branches on
the host; the others are the batched solvers of ``batched.py`` run as
a batch of one, and the per-entity quasi-Newton route runs them over a
whole bucket.
"""

from __future__ import annotations

from photon_tpu_torch.optim.base import (
    ConvergenceReason,
    OptimizerConfig,
    OptimizerType,
    OptResult,
    Tolerances,
    absolute_tolerances,
    convergence_code,
    sharded_over,
)
from photon_tpu_torch.optim.base import project_box
from photon_tpu_torch.optim.lbfgs import lbfgs_solve
from photon_tpu_torch.optim.lbfgsb import lbfgsb_solve
from photon_tpu_torch.optim.owlqn import owlqn_solve
from photon_tpu_torch.optim.regularization import (
    RegularizationContext,
    RegularizationType,
    inverse_prior_variances,
    with_gaussian_prior,
    with_gaussian_prior_hvp,
    with_l2,
    with_l2_hvp,
    with_l2_hvp_masked,
    with_l2_masked,
)
from photon_tpu_torch.optim.tron import tron_solve

__all__ = [
    "ConvergenceReason",
    "OptResult",
    "OptimizerConfig",
    "OptimizerType",
    "RegularizationContext",
    "RegularizationType",
    "Tolerances",
    "absolute_tolerances",
    "convergence_code",
    "inverse_prior_variances",
    "lbfgs_solve",
    "lbfgsb_solve",
    "owlqn_solve",
    "project_box",
    "sharded_over",
    "solve",
    "tron_solve",
    "with_gaussian_prior",
    "with_gaussian_prior_hvp",
    "with_l2",
    "with_l2_hvp",
    "with_l2_hvp_masked",
    "with_l2_masked",
]


def not_ported(what: str, item: int | None = None) -> NotImplementedError:
    where = "ROADMAP Queue A" + ("" if item is None else f" item {item}")
    return NotImplementedError(
        f"{what} is not ported to photon_tpu_torch yet ({where})")


def solve(fun, w0, config: OptimizerConfig | None = None, *,
          l1_weight: float = 0.0, l2_weight: float = 0.0,
          intercept_index: int | None = None, hvp=None,
          tolerances: Tolerances | None = None) -> OptResult:
    """Compose L2 onto ``fun`` (intercept excluded) and run the solver
    the factory picks: OWL-QN for any L1 part, TRON (with ``hvp``),
    else L-BFGS, which hands box constraints to L-BFGS-B."""
    config = config or OptimizerConfig()
    obj = fun if l2_weight == 0.0 else with_l2(fun, l2_weight,
                                               intercept_index)
    if l1_weight != 0.0:
        return owlqn_solve(obj, w0, l1_weight, config, tolerances=tolerances)
    if config.optimizer_type == OptimizerType.TRON:
        if hvp is None:
            raise ValueError("TRON requires a Hessian-vector-product closure")
        obj_hvp = (hvp if l2_weight == 0.0
                   else with_l2_hvp(hvp, l2_weight, intercept_index))
        return tron_solve(obj, obj_hvp, w0, config, tolerances=tolerances)
    return lbfgs_solve(obj, w0, config, tolerances=tolerances)
