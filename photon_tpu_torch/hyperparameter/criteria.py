"""Acquisition criteria (prediction transformations) for Bayesian search
(port of ``photon_tpu/hyperparameter/criteria.py``).

Counterpart of photon-lib hyperparameter/criteria/
ExpectedImprovement.scala:58 and ConfidenceBound.scala:48, plus the
PredictionTransformation contract (estimators/PredictionTransformation.scala).
Each criterion is a callable (means, variances) -> scores, elementwise on
host float64 tensors, so it applies to a whole [S, m] batch of posterior
samples at once.
"""

from __future__ import annotations

import dataclasses

import torch

from photon_tpu_torch.hyperparameter.kernels import as_tensor

_INV_SQRT_2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def _norm_cdf(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.special.erf(z * _INV_SQRT_2))


def _norm_pdf(z: torch.Tensor) -> torch.Tensor:
    return _INV_SQRT_2PI * torch.exp(-0.5 * z * z)


@dataclasses.dataclass(frozen=True)
class ExpectedImprovement:
    """EI against the best (lowest) observed evaluation; maximized.

    Reference: ExpectedImprovement.scala:58 — gamma = -(mean - best)/std,
    EI = std * (gamma * Phi(gamma) + phi(gamma)) (PBO eqs. 1-2). The search
    minimizes the evaluation value, so EI is maximized.
    """

    best_evaluation: float
    is_max_opt: bool = True

    def __call__(self, means, variances) -> torch.Tensor:
        std = torch.sqrt(as_tensor(variances))
        gamma = -(as_tensor(means) - self.best_evaluation) / std
        return std * (gamma * _norm_cdf(gamma) + _norm_pdf(gamma))


@dataclasses.dataclass(frozen=True)
class ConfidenceBound:
    """Lower confidence bound mean - k*std; minimized.

    Reference: ConfidenceBound.scala:48 (explorationFactor default 2.0,
    PBO eq. 3)."""

    exploration_factor: float = 2.0
    is_max_opt: bool = False

    def __call__(self, means, variances) -> torch.Tensor:
        return as_tensor(means) - self.exploration_factor * torch.sqrt(
            as_tensor(variances))
