"""Feature normalization as affine algebra on coefficient vectors (port
of ``photon_tpu/ops/normalization.py``).

The transform is x' = (x - shift) * factor, with the intercept column
never shifted nor scaled. Solvers run in the transformed space; the
coefficients round-trip to the original space with margins unchanged:

    w = w' * factor;   b = b' - (w . shift)
    w' = w / factor;   b' = b + (w . shift)

The GLM objective never transforms the data: for raw features x,
x' . w' = x . ew - es with ew = factor * w' and es = shift . ew.

``build_normalization_context`` makes the factors and shifts from
per-feature statistics (``stat.FeatureDataStatistics``).
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class NormalizationType(enum.Enum):
    """Reference: NormalizationType.scala:42."""

    NONE = "NONE"
    SCALE_WITH_STANDARD_DEVIATION = "SCALE_WITH_STANDARD_DEVIATION"
    SCALE_WITH_MAX_MAGNITUDE = "SCALE_WITH_MAX_MAGNITUDE"
    STANDARDIZATION = "STANDARDIZATION"


@dataclasses.dataclass(frozen=True)
class NormalizationContext:
    """Affine feature transform; ``factors is None`` means all ones and
    ``shifts is None`` all zeros (a default instance is the identity)."""

    factors: torch.Tensor | None = None
    shifts: torch.Tensor | None = None
    intercept_index: int | None = None

    def __post_init__(self):
        if self.shifts is not None and self.intercept_index is None:
            raise ValueError(
                "Normalization with shifts requires an intercept "
                "(reference NormalizationContext.scala:49)"
            )

    @property
    def is_identity(self) -> bool:
        return self.factors is None and self.shifts is None

    def effective_coefficients(self, coef: torch.Tensor):
        """(ew, es) such that margin = x . ew - es for raw features x."""
        ew = coef if self.factors is None else coef * self.factors
        if self.shifts is None:
            es = torch.zeros((), dtype=coef.dtype, device=coef.device)
        else:
            es = torch.dot(self.shifts.to(coef.dtype), ew)
        return ew, es

    def effective_gradient(self, raw_grad: torch.Tensor,
                           grad_dot_total: torch.Tensor) -> torch.Tensor:
        """Map ``X^T g`` taken on raw features to the transformed space:
        factor * (raw_grad - shift * sum(g))."""
        g = raw_grad
        if self.shifts is not None:
            g = g - self.shifts.to(g.dtype) * grad_dot_total
        if self.factors is not None:
            g = g * self.factors.to(g.dtype)
        return g

    def coef_to_original_space(self, coef: torch.Tensor) -> torch.Tensor:
        out = coef if self.factors is None else coef * self.factors
        if self.shifts is not None:
            adj = torch.dot(out, self.shifts.to(out.dtype))
            out = out.clone()
            out[self.intercept_index] -= adj
        return out

    def coef_to_transformed_space(self, coef: torch.Tensor) -> torch.Tensor:
        out = coef
        if self.shifts is not None:
            adj = torch.dot(out, self.shifts.to(out.dtype))
            out = out.clone()
            out[self.intercept_index] += adj
        if self.factors is not None:
            out = out / self.factors
        return out

    def var_to_transformed_space(self, variances: torch.Tensor):
        if self.factors is None:
            return variances
        return variances / (self.factors * self.factors)


def no_normalization() -> NormalizationContext:
    """Reference: NoNormalization()."""
    return NormalizationContext()


def _inverse_or_one(scale: torch.Tensor) -> torch.Tensor:
    """1 / scale, and 1 where the scale is 0 (a constant column passes
    through untouched)."""
    zero = scale == 0.0
    return torch.where(zero, torch.ones_like(scale),
                       1.0 / torch.where(zero, torch.ones_like(scale),
                                         scale))


def build_normalization_context(
    normalization_type: NormalizationType,
    *,
    mean: torch.Tensor | None = None,
    variance: torch.Tensor | None = None,
    min_: torch.Tensor | None = None,
    max_: torch.Tensor | None = None,
    intercept_index: int | None = None,
) -> NormalizationContext:
    """A context from per-feature statistics, on their device and in
    their dtype (NormalizationContext.apply, scala:162-220): a feature
    of zero spread gets factor 1, the intercept is never scaled, and
    standardization shifts every other feature by its mean."""
    if normalization_type == NormalizationType.NONE:
        return no_normalization()
    if normalization_type == NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
        if min_ is None or max_ is None:
            raise ValueError("max-magnitude scaling needs min/max statistics")
        factors = _inverse_or_one(torch.maximum(max_.abs(), min_.abs()))
    elif normalization_type in (
            NormalizationType.SCALE_WITH_STANDARD_DEVIATION,
            NormalizationType.STANDARDIZATION):
        if variance is None:
            raise ValueError("std scaling needs variance statistics")
        factors = _inverse_or_one(torch.sqrt(variance))
    else:
        raise ValueError(f"Unknown normalization type: {normalization_type}")
    if normalization_type != NormalizationType.STANDARDIZATION:
        if intercept_index is not None:
            factors[intercept_index] = 1.0
        return NormalizationContext(factors=factors)
    if mean is None:
        raise ValueError("standardization needs mean/variance statistics")
    if intercept_index is None:
        raise ValueError(
            "standardization (shifting) requires an intercept column "
            "(reference GameTrainingDriver normalization validation)")
    factors[intercept_index] = 1.0
    shifts = mean.clone()
    shifts[intercept_index] = 0.0
    return NormalizationContext(factors=factors, shifts=shifts,
                                intercept_index=intercept_index)
