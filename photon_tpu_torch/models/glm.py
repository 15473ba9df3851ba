"""GLM data holders (port of ``photon_tpu/models/glm.py``).

Serving reads only the coefficients and the task, so here the two
classes carry tensors and nothing else; scoring and the link functions
come with the training slice.
"""

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


@dataclasses.dataclass(frozen=True)
class GeneralizedLinearModel:
    """A task-typed GLM (GeneralizedLinearModel.scala:33)."""

    coefficients: Coefficients
    task: TaskType
