"""Evaluation-function adapters: hyperparameter vector -> retrain -> metric.

Port of ``photon_tpu/hyperparameter/evaluation.py``, the counterpart of
photon-lib hyperparameter/EvaluationFunction.scala:25 (the search-facing
contract) and photon-client
estimators/GameEstimatorEvaluationFunction.scala:40 (the GAME adapter): a
candidate point in the unit cube is scaled back to (log-space)
regularization weights / elastic-net alphas, expanded into a full GAME
optimization configuration, and evaluated by a FULL retrain + validation
evaluation. Lower values are better inside the search; maximize-metrics
(AUC) are sign-flipped on the way in and out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Protocol

import numpy as np

from photon_tpu_torch.algorithm.problems import GLMOptimizationConfiguration
from photon_tpu_torch.hyperparameter.rescaling import (
    DoubleRange,
    scale_backward,
    scale_forward,
)
from photon_tpu_torch.optim.regularization import RegularizationType

# GameEstimatorEvaluationFunction.scala:242-243.
DEFAULT_REG_WEIGHT_RANGE = DoubleRange(1e-4, 1e4)
DEFAULT_REG_ALPHA_RANGE = DoubleRange(0.0, 1.0)



class EvaluationFunction(Protocol):
    """hyperparameter/EvaluationFunction.scala:25."""

    def __call__(self, candidate: np.ndarray) -> tuple[float, object]: ...

    def convert_observations(
        self, results: list
    ) -> list[tuple[np.ndarray, float]]: ...


@dataclasses.dataclass
class GameEstimatorEvaluationFunction:
    """Adapter: unit-cube candidate -> GAME retrain -> validation metric.

    Reference: GameEstimatorEvaluationFunction.scala:40. The hyperparameter
    vector packs, per coordinate sorted by id: log(lambda) for L1/L2/
    ELASTIC_NET coordinates, plus alpha for ELASTIC_NET (NONE coordinates
    contribute no dimensions) — configurationToVector :151-183 /
    vectorToConfiguration :191-230.
    """

    estimator: object  # GameEstimator
    base_config: dict[str, GLMOptimizationConfiguration]
    data: object  # GameDataset
    validation_data: object  # GameDataset
    is_opt_max: bool
    # Warm-start / incremental-training model, forwarded into every retrain
    # (required when the estimator has incremental_training enabled).
    initial_model: object | None = None

    def __post_init__(self):
        self._coordinate_ids = sorted(self.base_config)
        ranges: list[DoubleRange] = []
        self._weight_range: dict[str, DoubleRange] = {}
        for cid in self._coordinate_ids:
            cfg = self.base_config[cid]
            raw_range = (
                DoubleRange(*cfg.regularization_weight_range)
                if cfg.regularization_weight_range is not None
                else DEFAULT_REG_WEIGHT_RANGE
            )
            if raw_range.start <= 0.0:
                raise ValueError(
                    f"coordinate {cid!r}: regularization weight range must "
                    f"start above 0 (weights are searched in log space), "
                    f"got {raw_range.start}"
                )
            self._weight_range[cid] = raw_range
            reg_range = raw_range.transform(math.log)
            alpha_range = (
                DoubleRange(*cfg.elastic_net_param_range)
                if cfg.elastic_net_param_range is not None
                else DEFAULT_REG_ALPHA_RANGE
            )
            t = cfg.regularization.regularization_type
            if t == RegularizationType.ELASTIC_NET:
                ranges.extend([reg_range, alpha_range])
            elif t in (RegularizationType.L1, RegularizationType.L2):
                ranges.append(reg_range)
        self.ranges = ranges
        self.num_params = len(ranges)

    # -- EvaluationFunction contract ---------------------------------------

    def __call__(self, candidate: np.ndarray) -> tuple[float, object]:
        scaled = scale_backward(candidate, self.ranges)
        config = self.vector_to_configuration(scaled)
        result = self.estimator.fit(
            self.data, self.validation_data, [config],
            initial_model=self.initial_model,
        )[0]
        direction = -1.0 if self.is_opt_max else 1.0
        return direction * result.evaluation.primary_evaluation, result

    def convert_observations(self, results) -> list[tuple[np.ndarray, float]]:
        out = []
        for result in results:
            vec = self.vectorize_params(result)
            scaled = scale_forward(vec, self.ranges)
            direction = -1.0 if self.is_opt_max else 1.0
            out.append((scaled, direction * self.get_evaluation_value(result)))
        return out

    def vectorize_params(self, result) -> np.ndarray:
        return self.configuration_to_vector(result.config)

    @staticmethod
    def get_evaluation_value(result) -> float:
        if result.evaluation is None:
            raise ValueError(
                "Can't extract evaluation value from a GAME result with no "
                "evaluations"
            )
        return result.evaluation.primary_evaluation

    # -- config <-> vector --------------------------------------------------

    def configuration_to_vector(
        self, configuration: dict[str, GLMOptimizationConfiguration]
    ) -> np.ndarray:
        if set(configuration) != set(self.base_config):
            raise ValueError(
                "Configuration coordinates mismatch; "
                f"{sorted(configuration)} != {self._coordinate_ids}"
            )
        values: list[float] = []
        for cid in self._coordinate_ids:
            cfg = configuration[cid]
            t = cfg.regularization.regularization_type
            # A grid config trained with lambda=0 must still vectorize — the
            # reference's math.log(0) yields -Infinity and poisons the GP, so
            # zero maps to the coordinate's configured range start (a fixed
            # 1e-12 floor would land far outside the unit cube and distort
            # the GP posterior near the boundary). Positive out-of-range
            # weights pass through unclamped: their true (out-of-cube)
            # location is finite and more honest to the GP than a relocated
            # boundary observation.
            w = cfg.regularization_weight
            if w <= 0.0:
                w = self._weight_range[cid].start
            if t == RegularizationType.ELASTIC_NET:
                alpha = (
                    1.0 if cfg.regularization.alpha is None
                    else cfg.regularization.alpha
                )
                values.extend([math.log(w), alpha])
            elif t in (RegularizationType.L1, RegularizationType.L2):
                values.append(math.log(w))
        return np.asarray(values)

    def vector_to_configuration(
        self, hyperparameters: np.ndarray
    ) -> dict[str, GLMOptimizationConfiguration]:
        if len(hyperparameters) != self.num_params:
            raise ValueError(
                f"Configuration dimension mismatch; {self.num_params} != "
                f"{len(hyperparameters)}"
            )
        queue = list(np.asarray(hyperparameters, dtype=float))
        out: dict[str, GLMOptimizationConfiguration] = {}
        for cid in self._coordinate_ids:
            cfg = self.base_config[cid]
            t = cfg.regularization.regularization_type
            if t == RegularizationType.ELASTIC_NET:
                weight = math.exp(queue.pop(0))
                alpha = min(max(queue.pop(0), 0.0), 1.0)
                out[cid] = dataclasses.replace(
                    cfg,
                    regularization=dataclasses.replace(
                        cfg.regularization, alpha=alpha
                    ),
                    regularization_weight=weight,
                )
            elif t in (RegularizationType.L1, RegularizationType.L2):
                out[cid] = cfg.with_regularization_weight(
                    math.exp(queue.pop(0))
                )
            else:
                out[cid] = cfg
        return out
