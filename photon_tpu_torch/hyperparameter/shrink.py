"""Shrink the hyperparameter search range around a prior optimum.

Port of ``photon_tpu/hyperparameter/shrink.py``, the counterpart of
photon-client hyperparameter/ShrinkSearchRange.scala:147 (getBounds): fit a
GP to prior observations (rescaled into the unit cube), locate the best
predicted point over a Sobol candidate pool, and return a ``radius``-wide
box around it in the CONFIG-RANGE space (i.e. transformed space for LOG/SQRT
variables — exactly what the reference's scaleBackward returns, ready to use
as new config ranges), clamped to the configured ranges — the warm-started
search-space reduction used when retraining on fresh data.
"""

from __future__ import annotations

import numpy as np

from photon_tpu_torch.hyperparameter.gp import GaussianProcessEstimator
from photon_tpu_torch.hyperparameter.rescaling import scale_backward
from photon_tpu_torch.hyperparameter.search import (
    _SobolGenerator,
    discretize_candidate,
)
from photon_tpu_torch.hyperparameter.serialization import (
    HyperparameterConfig,
    prior_from_json,
    rescale_prior_observations,
)


def get_bounds(
    config: HyperparameterConfig,
    prior_json: str,
    prior_default: dict[str, str],
    radius: float,
    candidate_pool_size: int = 1000,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """(lower, upper) bounds in config-range space
    (ShrinkSearchRange.getBounds): for LOG/SQRT variables these are
    transformed-space values, directly usable as new config ranges.

    The best candidate is the Sobol pool point with the LOWEST GP-predicted
    evaluation (the search minimizes); the box [best - radius, best + radius]
    on the unit cube maps back through scaleBackward and clamps to the
    configured ranges.
    """
    priors = prior_from_json(prior_json, prior_default, config.names)
    if not priors:
        raise ValueError("no prior observations to shrink around")
    rescaled = rescale_prior_observations(priors, config)
    points = np.stack([p for p, _ in rescaled])
    evals = np.asarray([v for _, v in rescaled])

    model = GaussianProcessEstimator(kernel="matern52", seed=seed).fit(
        points, evals)
    candidates = _SobolGenerator(len(config.names), seed).draw(
        candidate_pool_size)
    means, _ = model.predict(candidates)
    best = candidates[int(np.argmin(means))]

    discrete_set = set(config.discrete_params)
    upper = scale_backward(
        discretize_candidate(best + radius, config.discrete_params),
        config.ranges, discrete_set,
    )
    lower = scale_backward(
        discretize_candidate(best - radius, config.discrete_params),
        config.ranges, discrete_set,
    )
    for i, r in enumerate(config.ranges):
        upper[i] = min(upper[i], r.end)
        lower[i] = max(lower[i], r.start)
    return lower, upper
