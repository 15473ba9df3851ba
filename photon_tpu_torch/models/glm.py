"""GLM model objects (port of ``photon_tpu/models/glm.py``): the
coefficients and a task-typed GLM whose score is the linear margin."""

from __future__ import annotations

import dataclasses

import torch

from photon_tpu_torch.types import TaskType


@dataclasses.dataclass(frozen=True)
class Coefficients:
    """Means and optional variances of a GLM's coefficients
    (photon-lib model/Coefficients.scala:31)."""

    means: torch.Tensor  # [d]
    variances: torch.Tensor | None = None  # [d]

    def compute_score(self, features) -> torch.Tensor:
        """x . w per row (Coefficients.computeScore :51)."""
        return features.matvec(self.means)


@dataclasses.dataclass(frozen=True)
class GeneralizedLinearModel:
    """A task-typed GLM (GeneralizedLinearModel.scala:33)."""

    coefficients: Coefficients
    task: TaskType

    def compute_score(self, features, offsets=None) -> torch.Tensor:
        z = self.coefficients.compute_score(features)
        return z if offsets is None else z + offsets
