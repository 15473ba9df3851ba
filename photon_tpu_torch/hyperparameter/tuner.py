"""Hyperparameter tuner entry point.

Port of ``photon_tpu/hyperparameter/tuner.py``, the counterpart of
photon-api hyperparameter/tuner/ — the HyperparameterTuner contract
(HyperparameterTuner.scala), the NONE/RANDOM/BAYESIAN mode switch, and the
AtlasTuner dispatch (AtlasTuner.scala:27). The reference resolves tuner
classes reflectively (HyperparameterTunerFactory.scala:19); here it's a
plain function.
"""

from __future__ import annotations

import enum

from photon_tpu_torch.hyperparameter.search import (
    GaussianProcessSearch,
    RandomSearch,
)


class HyperparameterTuningMode(enum.Enum):
    """HyperparameterTuningMode in the reference CLI."""

    NONE = "NONE"
    RANDOM = "RANDOM"
    BAYESIAN = "BAYESIAN"


def search(
    n: int,
    dimension: int,
    mode: HyperparameterTuningMode | str,
    evaluation_function,
    observations,
    prior_observations=(),
    discrete_params: dict[int, int] | None = None,
    seed: int = 0,
) -> list:
    """Run n tuning iterations; returns the evaluated results.

    Reference: AtlasTuner.search :27-45 — BAYESIAN builds a
    GaussianProcessSearch, RANDOM a RandomSearch, both seeded with the
    already-evaluated observations (the lambda-grid models).
    """
    mode = HyperparameterTuningMode(
        mode.upper() if isinstance(mode, str) else mode
    )
    if mode == HyperparameterTuningMode.NONE or n <= 0:
        return []
    if mode == HyperparameterTuningMode.BAYESIAN:
        searcher = GaussianProcessSearch(
            dimension, evaluation_function,
            discrete_params=discrete_params, seed=seed,
        )
    else:
        searcher = RandomSearch(
            dimension, evaluation_function,
            discrete_params=discrete_params, seed=seed,
        )
    return searcher.find_with_priors(
        n, list(observations), list(prior_observations)
    )
