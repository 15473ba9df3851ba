"""Random and Bayesian (GP) hyperparameter search.

Port of ``photon_tpu/hyperparameter/search.py``, the counterpart of
photon-lib hyperparameter/search/RandomSearch.scala:34 (Sobol-sequence
quasi-random draws, :46-51) and GaussianProcessSearch.scala:52 (GP posterior
over the evaluation function, expected-improvement candidate selection,
:79-120). Candidates live in the unit cube [0, 1]^d; the evaluation function
owns the mapping to real hyperparameters (see rescaling /
GameEstimatorEvaluationFunction).
"""

from __future__ import annotations

import math

import numpy as np

from photon_tpu_torch.hyperparameter.criteria import ExpectedImprovement
from photon_tpu_torch.hyperparameter.gp import GaussianProcessEstimator


class _SobolGenerator:
    """Quasi-random equidistributed draws in [0, 1]^d.

    The reference uses commons-math SobolSequenceGenerator skipped ahead by
    the seed (RandomSearch.scala:46-51); scipy's generator provides the same
    low-discrepancy sequence, drawn exactly as the reference draws it.
    """

    def __init__(self, dim: int, seed: int):
        from scipy.stats import qmc

        self._sobol = qmc.Sobol(d=dim, scramble=False)
        skip = seed % 65536
        if skip:
            self._sobol.fast_forward(skip)

    def draw(self, n: int) -> np.ndarray:
        return self._sobol.random(n)


class RandomSearch:
    """Uniform (Sobol) search of the unit cube (RandomSearch.scala:34).

    ``evaluation_function`` follows the EvaluationFunction contract
    (hyperparameter/EvaluationFunction.scala:25): ``apply(candidate) ->
    (value, result)`` where LOWER values are better (the adapter flips signs
    for maximize-metrics), and ``convert_observations(results) ->
    [(vector, value)]``.
    """

    def __init__(
        self,
        num_params: int,
        evaluation_function,
        discrete_params: dict[int, int] | None = None,
        kernel: str = "matern52",
        seed: int = 0,
    ):
        if num_params <= 0:
            raise ValueError("Number of parameters must be positive.")
        self.num_params = num_params
        self.evaluation_function = evaluation_function
        self.discrete_params = dict(discrete_params or {})
        self.kernel = kernel
        self.seed = seed
        self._sobol = _SobolGenerator(num_params, seed)

    # -- public API (find / findWithPriorObservations / findWithPriors) ----

    def find(self, n: int) -> list:
        return self.find_with_prior_observations(n, [])

    def find_with_prior_observations(self, n: int, prior_observations) -> list:
        """RandomSearch.findWithPriorObservations :104-117."""
        if n <= 0:
            raise ValueError("The number of results must be greater than zero.")
        candidate = self._discretize(self.draw_candidates(1)[0])
        _, result = self.evaluation_function(candidate)
        if n == 1:
            return [result]
        observations = self.evaluation_function.convert_observations([result])
        return [result] + self.find_with_priors(
            n - 1, observations, prior_observations
        )

    def find_with_priors(self, n: int, observations, prior_observations) -> list:
        """RandomSearch.findWithPriors :61-95."""
        if n <= 0:
            raise ValueError("The number of results must be greater than zero.")
        if not observations:
            raise ValueError("There must be at least one observation.")
        for point, value in observations[:-1]:
            self._on_observation(np.asarray(point, dtype=float), value)
        for point, value in prior_observations:
            self._on_prior_observation(np.asarray(point, dtype=float), value)

        results = []
        last_candidate, last_value = observations[-1]
        last_candidate = np.asarray(last_candidate, dtype=float)
        for _ in range(n):
            candidate = self._discretize(
                self._next(last_candidate, last_value)
            )
            value, result = self.evaluation_function(candidate)
            results.append(result)
            last_candidate, last_value = candidate, value
        return results

    # -- extension points ---------------------------------------------------

    def _next(self, last_candidate, last_value) -> np.ndarray:
        return self.draw_candidates(1)[0]

    def _on_observation(self, point: np.ndarray, value: float) -> None:
        pass

    def _on_prior_observation(self, point: np.ndarray, value: float) -> None:
        pass

    # -- helpers ------------------------------------------------------------

    def draw_candidates(self, n: int) -> np.ndarray:
        return self._sobol.draw(n)

    def _discretize(self, candidate: np.ndarray) -> np.ndarray:
        return discretize_candidate(candidate, self.discrete_params)


class GaussianProcessSearch(RandomSearch):
    """GP-guided search (GaussianProcessSearch.scala:52).

    Each step fits a GP (slice-sampled kernel hyperparameters) to the
    mean-centered observations plus any prior observations, scores a Sobol
    candidate pool by expected improvement, and evaluates the best candidate.
    Falls back to uniform draws until there are more observations than
    dimensions (under-determined regime).
    """

    def __init__(
        self,
        num_params: int,
        evaluation_function,
        discrete_params: dict[int, int] | None = None,
        kernel: str = "matern52",
        candidate_pool_size: int = 250,
        noisy_target: bool = True,
        seed: int = 0,
    ):
        super().__init__(
            num_params, evaluation_function, discrete_params, kernel, seed
        )
        self.candidate_pool_size = candidate_pool_size
        self.noisy_target = noisy_target
        self._points: list[np.ndarray] = []
        self._values: list[float] = []
        self._best = math.inf
        self._prior_points: list[np.ndarray] = []
        self._prior_values: list[float] = []
        self._prior_best = math.inf
        self.last_model = None

    def _on_observation(self, point, value) -> None:
        self._points.append(np.asarray(point, dtype=float))
        self._values.append(float(value))
        self._best = min(self._best, float(value))

    def _on_prior_observation(self, point, value) -> None:
        self._prior_points.append(np.asarray(point, dtype=float))
        self._prior_values.append(float(value))
        self._prior_best = min(self._prior_best, float(value))

    def _next(self, last_candidate, last_value) -> np.ndarray:
        """GaussianProcessSearch.next :79-120."""
        self._on_observation(last_candidate, last_value)

        if len(self._points) <= self.num_params:
            return super()._next(last_candidate, last_value)

        candidates = self.draw_candidates(self.candidate_pool_size)
        values = np.asarray(self._values)
        current_mean = float(values.mean())
        overall_best = min(self._prior_best, self._best - current_mean)
        transformation = ExpectedImprovement(overall_best)

        points = np.stack(self._points)
        evals = values - current_mean
        if self._prior_points:
            points = np.vstack([points, np.stack(self._prior_points)])
            evals = np.concatenate([evals, np.asarray(self._prior_values)])

        estimator = GaussianProcessEstimator(
            kernel=self.kernel,
            normalize_labels=False,
            noisy_target=self.noisy_target,
            seed=self.seed,
        )
        model = estimator.fit(points, evals)
        self.last_model = model

        predictions = model.predict_transformed(candidates, transformation)
        return self._select_best_candidate(
            candidates, predictions, transformation
        )

    @staticmethod
    def _select_best_candidate(candidates, predictions, transformation):
        """argmax (EI) or argmin (CB) over the pool
        (selectBestCandidate :166-189)."""
        idx = (
            int(np.argmax(predictions))
            if transformation.is_max_opt
            else int(np.argmin(predictions))
        )
        return candidates[idx]


def discretize_candidate(
    candidate: np.ndarray, discrete_params: dict[int, int]
) -> np.ndarray:
    """floor(v*k)/k on discrete dims (discretizeCandidate :168-180)."""
    out = np.array(candidate, dtype=float)
    for index, k in discrete_params.items():
        out[index] = math.floor(out[index] * k) / k
    return out
