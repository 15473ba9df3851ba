"""One coordinate's optimization configuration and the fixed-effect
GLM fit (port of ``photon_tpu/algorithm/problems.py``).

``GLMOptimizationProblem.run`` maps the initial coefficients to the
transformed space, solves there against the raw data through the
normalization's effective coefficients, and reports the model in the
original space (DistributedOptimizationProblem.scala:124-132). The
solver is the factory's choice (L-BFGS, L-BFGS-B for box constraints,
OWL-QN for an L1 part, TRON), and SIMPLE or FULL coefficient variances
are computed at the optimum (:86-103).
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
    # Hyperparameter tuning's search ranges
    # (CoordinateOptimizationConfiguration.scala:40-41
    # regularizationWeightRange / elasticNetParamRange); None means the
    # tuner's defaults apply.
    regularization_weight_range: tuple[float, float] | None = None
    elastic_net_param_range: tuple[float, float] | None = None
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
        """The fit. On column-sharded features (``parallel.mesh
        .FeatureShardedSparse``) each rank solves its slice of the
        coefficients: the initial and prior vectors (whole, as models
        are) and any per-feature box bounds are sliced to its feature
        range, the intercept's L2 exemption applies on its owner, every
        inner product and OWL-QN's L1 term cross the ranks
        (``optim.sharded_over``), FULL variances come from the gathered
        Hessian (``variances_in_transformed_space``), and the solved
        slices are gathered into the whole padded ``[d]`` model, the
        same on every rank."""
        cfg = self.config
        dtype = batch.labels.dtype
        dev = batch.labels.device
        feats = batch.features
        column = hasattr(feats, "local_slice")
        local = feats.local_slice if column else (lambda v: v)
        opt_config = cfg.optimizer
        if column and opt_config.box_constraints is not None:
            opt_config = dataclasses.replace(
                opt_config, box_constraints=feats.local_bounds(
                    opt_config.box_constraints))
        w0 = (torch.zeros(batch.num_features, dtype=dtype, device=dev)
              if initial is None else local(initial.means.to(dtype)))
        prior = None
        if self.prior is not None:
            if self.prior.variances is None:
                raise ValueError(
                    "incremental training requires prior variances "
                    "(GameEstimator.scala:241-382 invariants)")
            # Padded slots take variance 0: "absent from the prior".
            prior = (local(self.prior.means.to(dtype)),
                     local(self.prior.variances.to(dtype)))
        with optim.sharded_over(feats.mesh if column else None):
            means, variances, result = run_impl(
                batch, w0, cfg.l1_weight, cfg.l2_weight, self.normalization,
                prior, cfg.incremental_weight, task=self.task,
                opt_config=opt_config,
                intercept_index=(feats.local_index(self.intercept_index)
                                 if column else self.intercept_index),
                variance_computation=cfg.variance_computation,
            )
        if column:
            if variances is None:
                (means,) = feats.gather(means)
            else:
                means, variances = feats.gather(means, variances)
            result = result._replace(coefficients=means)
        model = GeneralizedLinearModel(Coefficients(means, variances),
                                       self.task)
        return GLMSolution(model=model, result=result)


def variances_in_transformed_space(batch: GLMBatch,
                                   loss: losses_mod.PointwiseLoss,
                                   coef_transformed: torch.Tensor,
                                   norm: NormalizationContext,
                                   l2_diag: torch.Tensor,
                                   variance_computation:
                                   VarianceComputationType) -> torch.Tensor:
    """Transformed-space variances at the optimum: SIMPLE inverts the
    Hessian's diagonal, FULL takes the diagonal of the inverse Hessian
    by Cholesky. ``l2_diag`` is the penalty's diagonal (0 at the
    intercept and at padded slots). A slot with zero curvature gets
    variance inf (and a unit pivot, so the Cholesky stays defined)."""
    if variance_computation == VarianceComputationType.SIMPLE:
        diag = glm_ops.hessian_diagonal(batch, loss, coef_transformed,
                                        norm) + l2_diag
        return 1.0 / torch.where(diag == 0.0, torch.inf, diag)
    feats = batch.features
    column = hasattr(feats, "local_slice")
    if column:
        # Column-sharded: this rank's row block with its own penalty on
        # the diagonal, gathered whole; every rank factors the same bits
        # and keeps its slice.
        rows = glm_ops.hessian_rows(batch, loss, coef_transformed, norm)
        cols = torch.arange(feats.d_local, device=rows.device)
        rows[cols, feats.lo + cols] += l2_diag
        h = feats.gather_hessian(rows)
    else:
        h = glm_ops.hessian_matrix(batch, loss, coef_transformed, norm)
        h = h + torch.diag(l2_diag)
    dead = torch.diagonal(h) == 0.0
    h = h + torch.diag(dead.to(h.dtype))
    var = torch.where(dead, torch.inf, cholesky_inverse_diagonal(h))
    return feats.local_slice(var) if column else var


def cholesky_inverse_diagonal(h: torch.Tensor) -> torch.Tensor:
    """diag(h^-1) of each SPD [..., S, S] by Cholesky; NaN where h is
    not positive definite (as ``jnp.linalg.cholesky`` reports it)."""
    chol, info = torch.linalg.cholesky_ex(h)
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    inv = torch.cholesky_solve(eye.expand_as(h), chol)
    return torch.where((info == 0)[..., None],
                       torch.diagonal(inv, dim1=-2, dim2=-1), torch.nan)


def compute_variances(batch: GLMBatch, loss: losses_mod.PointwiseLoss,
                      coef_transformed: torch.Tensor,
                      norm: NormalizationContext, l2_weight: float,
                      intercept_index: int | None,
                      variance_computation: VarianceComputationType):
    """Original-space variances at the optimum, or None: L2 adds l2 to
    every diagonal entry but the intercept's, and Var(w) = Var(w')
    factor^2."""
    if variance_computation == VarianceComputationType.NONE:
        return None
    return _to_original_variances(
        variances_in_transformed_space(
            batch, loss, coef_transformed, norm,
            _l2_diagonal(coef_transformed, l2_weight, intercept_index),
            variance_computation), norm)


def _l2_diagonal(like: torch.Tensor, l2_weight,
                 intercept_index: int | None) -> torch.Tensor:
    # A sum, not ``full_like``: ``l2_weight`` may be a 0-d device tensor.
    diag = torch.zeros_like(like) + l2_weight
    if intercept_index is not None:
        diag.narrow(0, intercept_index, 1).zero_()
    return diag


def _to_original_variances(var_t: torch.Tensor, norm: NormalizationContext):
    if norm.factors is None:
        return var_t
    return var_t * norm.factors * norm.factors


def run_impl(batch: GLMBatch, w0_orig: torch.Tensor, l1_weight,
             l2_weight, norm: NormalizationContext, prior,
             incremental_weight, *, task: TaskType,
             opt_config: optim.OptimizerConfig, intercept_index: int | None,
             variance_computation: VarianceComputationType,
             use_owlqn: bool | None = None, device_loops: bool = False):
    """Transform, solve, variances, round trip (the JAX
    ``_run_impl``). Returns (means, variances or None, OptResult).

    The fused fit passes the weights as 0-d tensors, ``use_owlqn`` (the
    static route) and ``device_loops``: L-BFGS then runs as
    ``batched.single(batched.lbfgs, ...)``, whose every branch is a
    ``torch.where`` and whose loops are device loops, in place of
    ``lbfgs_solve``, which branches on the host."""
    if use_owlqn is None:
        use_owlqn = l1_weight != 0.0
    loss = losses_mod.get_loss(task)
    w0 = norm.coef_to_transformed_space(w0_orig)
    fun = glm_ops.make_value_and_grad(batch, loss, norm)
    if prior is not None:
        # The prior replaces the L2 term; the L2 weight is the precision
        # of features absent from the prior (PriorDistribution.scala).
        means_t = norm.coef_to_transformed_space(prior[0])
        inv_var_t = optim.inverse_prior_variances(
            norm.var_to_transformed_space(prior[1]), l2_weight)
        obj = optim.with_gaussian_prior(fun, incremental_weight, means_t,
                                        inv_var_t)
    else:
        obj = optim.with_l2(fun, l2_weight, intercept_index)
    if use_owlqn:
        result = optim.owlqn_solve(obj, w0, l1_weight, opt_config)
    elif opt_config.optimizer_type == optim.OptimizerType.TRON:
        raw_hvp = glm_ops.make_hvp(batch, loss, norm)
        if prior is not None:
            hvp = optim.with_gaussian_prior_hvp(raw_hvp, incremental_weight,
                                                inv_var_t)
        else:
            hvp = optim.with_l2_hvp(raw_hvp, l2_weight, intercept_index)
        result = optim.tron_solve(obj, hvp, w0, opt_config)
    elif device_loops and opt_config.box_constraints is None:
        from photon_tpu_torch.optim import batched

        result = batched.single(batched.lbfgs, obj, w0, opt_config)
    else:
        result = optim.lbfgs_solve(obj, w0, opt_config)
    if prior is None:
        variances = compute_variances(
            batch, loss, result.coefficients, norm, l2_weight,
            intercept_index, variance_computation)
    elif variance_computation == VarianceComputationType.NONE:
        variances = None
    else:
        # The prior adds iw / var to every diagonal entry.
        variances = _to_original_variances(variances_in_transformed_space(
            batch, loss, result.coefficients, norm,
            incremental_weight * inv_var_t, variance_computation), norm)
    return (norm.coef_to_original_space(result.coefficients), variances,
            result)
