"""Regularization contexts and objective-closure composition (port of
``photon_tpu/optim/regularization.py``).

``with_l2*`` wrap a ``fun(w) -> (value, grad)`` closure, and the
``*_hvp`` forms a Hessian-vector product, adding 0.5 * l2 * |w|^2 with
the intercept (or a masked set of slots) left out of the penalty
(L2Regularization.scala:73-97). L1 belongs to OWL-QN, not here.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class RegularizationType(enum.Enum):
    NONE = "NONE"
    L1 = "L1"
    L2 = "L2"
    ELASTIC_NET = "ELASTIC_NET"


@dataclasses.dataclass(frozen=True)
class RegularizationContext:
    """Splits a total weight lambda into L1 and L2 parts; for
    ELASTIC_NET ``alpha`` is the L1 fraction (default 1.0)."""

    regularization_type: RegularizationType = RegularizationType.NONE
    alpha: float | None = None

    def __post_init__(self):
        if self.regularization_type == RegularizationType.ELASTIC_NET:
            a = 1.0 if self.alpha is None else self.alpha
            if not 0.0 <= a <= 1.0:
                raise ValueError(f"elastic net alpha must be in [0, 1]: {a}")
        elif self.alpha is not None:
            raise ValueError(f"alpha is only valid for ELASTIC_NET, not "
                             f"{self.regularization_type}")

    def _alpha(self) -> float:
        return 1.0 if self.alpha is None else self.alpha

    def l1_weight(self, reg_weight: float) -> float:
        t = self.regularization_type
        if t == RegularizationType.L1:
            return reg_weight
        if t == RegularizationType.ELASTIC_NET:
            return self._alpha() * reg_weight
        return 0.0

    def l2_weight(self, reg_weight: float) -> float:
        t = self.regularization_type
        if t == RegularizationType.L2:
            return reg_weight
        if t == RegularizationType.ELASTIC_NET:
            return (1.0 - self._alpha()) * reg_weight
        return 0.0


def _l2_mask(w: torch.Tensor, intercept_index: int | None) -> torch.Tensor:
    if intercept_index is None:
        return w
    w = w.clone()
    # A fill, not ``w[i] = 0.0`` (a copy from a host scalar, which a
    # CUDA-graph capture refuses).
    w.narrow(0, intercept_index, 1).zero_()
    return w


def with_l2(fun, l2_weight, intercept_index: int | None = None):
    """Add 0.5 * l2 * |w|^2 (intercept excluded) to value and grad."""

    def wrapped(w):
        f, g = fun(w)
        wm = _l2_mask(w, intercept_index)
        return f + 0.5 * l2_weight * torch.dot(wm, wm), g + l2_weight * wm

    return wrapped


def with_l2_hvp(hvp, l2_weight, intercept_index: int | None = None):
    def wrapped(w, d):
        return hvp(w, d) + l2_weight * _l2_mask(d, intercept_index)

    return wrapped


def with_l2_masked(fun, l2_weight, penalty_mask: torch.Tensor):
    """``with_l2`` with a 0/1 penalty mask in place of an index."""

    def wrapped(w):
        f, g = fun(w)
        wm = w * penalty_mask
        return f + 0.5 * l2_weight * torch.dot(wm, wm), g + l2_weight * wm

    return wrapped


def with_l2_hvp_masked(hvp, l2_weight, penalty_mask: torch.Tensor):
    def wrapped(w, d):
        return hvp(w, d) + l2_weight * (d * penalty_mask)

    return wrapped


# Variances at or below this magnitude mean "feature absent from the
# prior model" (MathConst.EPSILON).
PRIOR_VARIANCE_EPSILON = 1e-12


def inverse_prior_variances(prior_variances: torch.Tensor,
                            l2_weight) -> torch.Tensor:
    """1 / variance, with the plain L2 weight for absent features."""
    fallback = torch.as_tensor(l2_weight, dtype=prior_variances.dtype,
                               device=prior_variances.device)
    return torch.where(prior_variances.abs() > PRIOR_VARIANCE_EPSILON,
                       1.0 / prior_variances, fallback)


def with_gaussian_prior(fun, incremental_weight, prior_means, inv_prior_var):
    """The incremental-training prior penalty
    iw/2 * sum((w - m)^2 / var) (PriorDistribution.scala:31-137)."""

    def wrapped(w):
        f, g = fun(w)
        dw = (w - prior_means) * inv_prior_var
        val = 0.5 * incremental_weight * torch.dot(w - prior_means, dw)
        return f + val, g + incremental_weight * dw

    return wrapped


def with_gaussian_prior_hvp(hvp, incremental_weight, inv_prior_var):
    def wrapped(w, d):
        return hvp(w, d) + incremental_weight * (d * inv_prior_var)

    return wrapped
