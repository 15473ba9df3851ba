"""Hyperparameter tuning: Sobol random search + GP Bayesian search (port
of ``photon_tpu/hyperparameter``).

Counterpart of photon-lib hyperparameter/* (search, estimators, kernels,
criteria, slice sampler, rescaling) and the photon-api tuner dispatch.
The search and its GP run on the host (numpy and float64 torch on the
CPU, as the reference pins its GP to the host); each candidate it
evaluates is a full ``GameEstimator.fit`` on the estimator's device. See
the individual modules for file:line parity citations.
"""

from photon_tpu_torch.hyperparameter.criteria import (
    ConfidenceBound,
    ExpectedImprovement,
)
from photon_tpu_torch.hyperparameter.evaluation import (
    DEFAULT_REG_ALPHA_RANGE,
    DEFAULT_REG_WEIGHT_RANGE,
    GameEstimatorEvaluationFunction,
)
from photon_tpu_torch.hyperparameter.gp import (
    GaussianProcessEstimator,
    GaussianProcessModel,
)
from photon_tpu_torch.hyperparameter.rescaling import (
    DoubleRange,
    scale_backward,
    scale_forward,
    transform_backward,
    transform_forward,
)
from photon_tpu_torch.hyperparameter.search import (
    GaussianProcessSearch,
    RandomSearch,
)
from photon_tpu_torch.hyperparameter.serialization import (
    HyperparameterConfig,
    config_from_json,
    prior_from_json,
    rescale_prior_observations,
)
from photon_tpu_torch.hyperparameter.shrink import get_bounds
from photon_tpu_torch.hyperparameter.slice_sampler import SliceSampler
from photon_tpu_torch.hyperparameter.tuner import HyperparameterTuningMode, search

__all__ = [
    "ConfidenceBound",
    "ExpectedImprovement",
    "DEFAULT_REG_ALPHA_RANGE",
    "DEFAULT_REG_WEIGHT_RANGE",
    "GameEstimatorEvaluationFunction",
    "GaussianProcessEstimator",
    "GaussianProcessModel",
    "DoubleRange",
    "scale_backward",
    "scale_forward",
    "transform_backward",
    "transform_forward",
    "GaussianProcessSearch",
    "RandomSearch",
    "HyperparameterConfig",
    "config_from_json",
    "prior_from_json",
    "rescale_prior_observations",
    "get_bounds",
    "SliceSampler",
    "HyperparameterTuningMode",
    "search",
]
