"""One coordinate's optimization configuration and the fixed-effect
GLM fit (port of ``photon_tpu/algorithm/problems.py``).

``GLMOptimizationProblem.run`` maps the initial coefficients to the
transformed space, solves there against the raw data through the
normalization's effective coefficients, and reports the model in the
original space (DistributedOptimizationProblem.scala:124-132). Only the
L-BFGS route is ported; coefficient variances, OWL-QN and TRON raise
``NotImplementedError`` (ROADMAP Queue A).
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from photon_tpu_torch import optim
from photon_tpu_torch.data.dataset import GLMBatch
from photon_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_tpu_torch.ops import glm as glm_ops
from photon_tpu_torch.ops import losses as losses_mod
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.types import TaskType


class VarianceComputationType(enum.Enum):
    NONE = "NONE"
    SIMPLE = "SIMPLE"
    FULL = "FULL"


@dataclasses.dataclass(frozen=True)
class GLMOptimizationConfiguration:
    """Optimizer, regularization and lambda for one coordinate
    (GLMOptimizationConfiguration.scala)."""

    optimizer: optim.OptimizerConfig = dataclasses.field(
        default_factory=optim.OptimizerConfig)
    regularization: optim.RegularizationContext = dataclasses.field(
        default_factory=optim.RegularizationContext)
    regularization_weight: float = 0.0
    down_sampling_rate: float = 1.0
    variance_computation: VarianceComputationType = (
        VarianceComputationType.NONE)
    incremental_weight: float = 1.0

    def with_regularization_weight(self, weight: float):
        return dataclasses.replace(self, regularization_weight=weight)

    @property
    def l1_weight(self) -> float:
        return self.regularization.l1_weight(self.regularization_weight)

    @property
    def l2_weight(self) -> float:
        return self.regularization.l2_weight(self.regularization_weight)


@dataclasses.dataclass(frozen=True)
class GLMSolution:
    model: GeneralizedLinearModel
    result: optim.OptResult


@dataclasses.dataclass(frozen=True)
class GLMOptimizationProblem:
    """One GLM fit: objective assembly, transformed-space solve and the
    round trip to the original space. ``prior`` (original-space means
    and variances) replaces the plain L2 term for incremental
    training."""

    task: TaskType
    config: GLMOptimizationConfiguration
    normalization: NormalizationContext = dataclasses.field(
        default_factory=NormalizationContext)
    intercept_index: int | None = None
    prior: Coefficients | None = None

    def run(self, batch: GLMBatch,
            initial: Coefficients | None = None) -> GLMSolution:
        cfg = self.config
        dtype = batch.labels.dtype
        dev = batch.labels.device
        w0 = (torch.zeros(batch.num_features, dtype=dtype, device=dev)
              if initial is None else initial.means.to(dtype))
        prior = None
        if self.prior is not None:
            if self.prior.variances is None:
                raise ValueError(
                    "incremental training requires prior variances "
                    "(GameEstimator.scala:241-382 invariants)")
            prior = (self.prior.means.to(dtype),
                     self.prior.variances.to(dtype))
        means, variances, result = run_impl(
            batch, w0, cfg.l1_weight, cfg.l2_weight, self.normalization,
            prior, cfg.incremental_weight, task=self.task,
            opt_config=cfg.optimizer, intercept_index=self.intercept_index,
            variance_computation=cfg.variance_computation,
        )
        model = GeneralizedLinearModel(Coefficients(means, variances),
                                       self.task)
        return GLMSolution(model=model, result=result)


def run_impl(batch: GLMBatch, w0_orig: torch.Tensor, l1_weight: float,
             l2_weight: float, norm: NormalizationContext, prior,
             incremental_weight: float, *, task: TaskType,
             opt_config: optim.OptimizerConfig, intercept_index: int | None,
             variance_computation: VarianceComputationType):
    """Transform, solve, round trip (the JAX ``_run_impl``'s L-BFGS
    route). Returns (means, variances, OptResult)."""
    if l1_weight != 0.0:
        raise optim.not_ported("OWL-QN (L1 regularization)")
    if opt_config.optimizer_type == optim.OptimizerType.TRON:
        raise optim.not_ported("TRON")
    if variance_computation != VarianceComputationType.NONE:
        raise optim.not_ported("coefficient variances")
    loss = losses_mod.get_loss(task)
    w0 = norm.coef_to_transformed_space(w0_orig)
    fun = glm_ops.make_value_and_grad(batch, loss, norm)
    if prior is not None:
        means_t = norm.coef_to_transformed_space(prior[0])
        inv_var_t = optim.inverse_prior_variances(
            norm.var_to_transformed_space(prior[1]), l2_weight)
        obj = optim.with_gaussian_prior(fun, incremental_weight, means_t,
                                        inv_var_t)
    else:
        obj = optim.with_l2(fun, l2_weight, intercept_index)
    result = optim.lbfgs_solve(obj, w0, opt_config)
    return norm.coef_to_original_space(result.coefficients), None, result
