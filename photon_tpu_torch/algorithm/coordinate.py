"""The fixed-effect coordinate (port of
``photon_tpu/algorithm/coordinate.py``).

A coordinate trains against its batch's base offsets plus the residual
scores of every other coordinate (Coordinate.scala:52-53), and its
``score`` is the pure model contribution per row, with no offset. A
``down_sampling_rate`` under 1 masks rows per train call with draws
seeded by the call's seed (FixedEffectCoordinate.trainModel ->
DistributedOptimizationProblem.runWithSampling :141-167).

On a row-sharded batch (``batch.mesh``) the coordinate trains on this
rank's share of the rows against its share of the replicated residual
vector, and ``score`` gathers every rank's share into the replicated
``[n]`` scores, cut back to the logical rows (reference
``algorithm/coordinate.py:66``).

On a column-sharded batch (``parallel.mesh.FeatureShardedSparse``) the
rows are whole, the solve runs on each rank's feature slice, and the
gathered model is trimmed to the logical feature count, so every rank
returns the same whole model (reference :97-116); ``score`` is the
column ``matvec``, which sums the ranks' partial margins.
"""

from __future__ import annotations

import dataclasses

import torch

from photon_tpu_torch.algorithm.problems import (
    GLMOptimizationConfiguration,
    GLMOptimizationProblem,
)
from photon_tpu_torch.data import sampling
from photon_tpu_torch.data.dataset import GLMBatch
from photon_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_tpu_torch.parallel.mesh import maybe_row_shard
from photon_tpu_torch.types import TaskType


@dataclasses.dataclass(frozen=True)
class FixedEffectCoordinate:
    """Global GLM coordinate over one feature shard
    (FixedEffectCoordinate.scala:33)."""

    batch: GLMBatch
    problem: GLMOptimizationProblem

    @property
    def config(self) -> GLMOptimizationConfiguration:
        return self.problem.config

    def train(self, residuals: torch.Tensor | None = None,
              initial_model: GeneralizedLinearModel | None = None, *,
              seed: int = 0):
        batch = self.batch
        if residuals is not None:
            if batch.mesh is not None:
                (residuals,) = maybe_row_shard(batch.mesh, residuals)
            batch = batch.with_offsets(batch.offsets + residuals)
        rate = self.config.down_sampling_rate
        if 0.0 < rate < 1.0:
            batch = sampling.downsample(
                batch, rate, seed, binary=self.problem.task in (
                    TaskType.LOGISTIC_REGRESSION,
                    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM))
        initial = (initial_model.coefficients if initial_model is not None
                   else None)
        solution = self.problem.run(batch, initial)
        model = solution.model
        logical_d = getattr(batch.features, "logical_d", None)
        if logical_d is not None and logical_d != batch.features.d:
            coefs = model.coefficients
            model = dataclasses.replace(model, coefficients=Coefficients(
                coefs.means[:logical_d],
                None if coefs.variances is None
                else coefs.variances[:logical_d]))
        return model, solution.result

    def score(self, model: GeneralizedLinearModel) -> torch.Tensor:
        s = model.coefficients.compute_score(self.batch.features)
        if self.batch.mesh is not None:
            s = self.batch.mesh.gather_rows(s, self.batch.logical_rows)
        return s
