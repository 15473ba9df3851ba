"""Optimizers (port of ``photon_tpu/optim``).

``solve`` mirrors OptimizerFactory (OptimizerFactory.scala:74): L2 is
folded into the objective, a nonzero L1 weight routes to OWL-QN and a
TRON config to TRON. Only L-BFGS is ported so far; OWL-QN, TRON and
L-BFGS-B raise ``NotImplementedError`` (ROADMAP Queue A).
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
)
from photon_tpu_torch.optim.lbfgs import lbfgs_solve
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
    "solve",
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
          intercept_index: int | None = None,
          tolerances: Tolerances | None = None) -> OptResult:
    """Compose L2 onto ``fun`` and run the configured solver."""
    config = config or OptimizerConfig()
    if l1_weight != 0.0:
        raise not_ported("OWL-QN (L1 regularization)")
    if config.optimizer_type == OptimizerType.TRON:
        raise not_ported("TRON")
    obj = fun if l2_weight == 0.0 else with_l2(fun, l2_weight,
                                               intercept_index)
    return lbfgs_solve(obj, w0, config, tolerances=tolerances)
