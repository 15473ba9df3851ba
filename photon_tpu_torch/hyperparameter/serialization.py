"""Hyperparameter config / prior-observation JSON (de)serialization.

Port of ``photon_tpu/hyperparameter/serialization.py``, the counterpart of
photon-lib hyperparameter/HyperparameterSerialization.scala:136 and
HyperparameterConfig.scala: the JSON vocabulary that names tunable
hyperparameters, their ranges, discretization, and LOG/SQRT transforms, plus
prior observations from past datasets (the ``records`` list consumed by
``findWithPriors``).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from photon_tpu_torch.hyperparameter.rescaling import (
    DoubleRange,
    rescale_priors,
)
from photon_tpu_torch.hyperparameter.tuner import HyperparameterTuningMode


@dataclasses.dataclass(frozen=True)
class HyperparameterConfig:
    """Reference: HyperparameterConfig.scala — tuning mode + per-parameter
    names / ranges / discrete cardinalities / transforms."""

    tuning_mode: HyperparameterTuningMode
    names: list[str]
    ranges: list[DoubleRange]
    discrete_params: dict[int, int]
    transform_map: dict[int, str]


def config_from_json(json_config: str) -> HyperparameterConfig:
    """Parse the tuner config document (configFromJson :58-120).

    Expected shape::

        {"tuning_mode": "BAYESIAN",
         "variables": {"global.regularizer": {
             "type": "CONTINUOUS", "min": -4, "max": 4,
             "transform": "LOG"}}}

    DISCRETE variables widen their range by 1 on the unit-cube side (the
    reference's discreteParam handling in VectorRescaling).
    """
    raw = json.loads(json_config)
    mode_name = str(raw.get("tuning_mode", "NONE")).upper()
    try:
        mode = HyperparameterTuningMode(mode_name)
    except ValueError:
        raise ValueError(
            f"unknown tuning_mode {mode_name!r}; expected one of "
            f"{[m.value for m in HyperparameterTuningMode]}") from None
    variables = raw["variables"]
    names = sorted(variables)
    ranges: list[DoubleRange] = []
    discrete: dict[int, int] = {}
    transforms: dict[int, str] = {}
    for i, name in enumerate(names):
        spec = variables[name]
        lo, hi = float(spec["min"]), float(spec["max"])
        ranges.append(DoubleRange(lo, hi))
        if str(spec.get("type", "CONTINUOUS")).upper() == "DISCRETE":
            discrete[i] = int(hi - lo) + 1
        if spec.get("transform") is not None:
            transforms[i] = str(spec["transform"]).upper()
    return HyperparameterConfig(
        tuning_mode=mode,
        names=names,
        ranges=ranges,
        discrete_params=discrete,
        transform_map=transforms,
    )


def prior_from_json(
    prior_json: str,
    prior_default: dict[str, str],
    hyperparameter_list: list[str],
) -> list[tuple[np.ndarray, float]]:
    """Parse prior observations (priorFromJson :33-56): a ``records`` list of
    string maps, each carrying ``evaluationValue`` plus per-parameter values
    (absent parameters fall back to ``prior_default``)."""
    raw = json.loads(prior_json)
    out: list[tuple[np.ndarray, float]] = []
    for rec in raw["records"]:
        value = float(rec["evaluationValue"])
        vec = np.array([
            float(rec[name] if name in rec else prior_default[name])
            for name in hyperparameter_list
        ])
        out.append((vec, value))
    return out


def rescale_prior_observations(
    priors: list[tuple[np.ndarray, float]],
    config: HyperparameterConfig,
) -> list[tuple[np.ndarray, float]]:
    """Transform + scale prior observations into the unit cube
    (VectorRescaling.rescalePriors with the config's transform map)."""
    return rescale_priors(
        priors, config.ranges, config.transform_map,
        set(config.discrete_params),
    )
