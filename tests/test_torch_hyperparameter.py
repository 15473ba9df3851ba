"""The port's hyperparameter package against the JAX package's, on the CPU.

The first part is ``tests/test_hyperparameter.py`` case for case, on
``photon_tpu_torch.hyperparameter`` (its GAME cases train the port's
``GameEstimator`` in float64 on the CPU). The second holds each module
against its reference twin on the same numpy inputs, made from a seed,
with the reference under x64 as the test conftest sets it:

- ``gram``, ``cross`` and ``log_likelihood`` within 1e-12 (relative to
  the magnitude): the same float64 formulas, matrix products and
  Cholesky factors in another library's order;
- EI and the confidence bound within 1e-12: the same elementwise
  float64 formulas (``torch.special.erf`` for ``lax.erf``);
- a GP's ``predict`` within 1e-9: both slice samplers walk the same
  numpy path from the same seed, so the posterior samples agree to
  rounding, and the [n, n] solves add at most ~cond(K) u;
- ``RandomSearch`` draws the same candidates bit for bit (scipy's
  Sobol sequence in both), ``GaussianProcessSearch`` within 1e-9 (its
  candidates are Sobol points chosen by the argmax of EI, so equal
  unless two EI values tie within the GP's rounding).
"""

from __future__ import annotations

import importlib
import json
import math

import numpy as np
import pytest
import torch

from photon_tpu_torch.hyperparameter import (
    ConfidenceBound,
    DoubleRange,
    ExpectedImprovement,
    GaussianProcessEstimator,
    GaussianProcessSearch,
    RandomSearch,
    SliceSampler,
    scale_backward,
    scale_forward,
    transform_backward,
    transform_forward,
)
from photon_tpu_torch.hyperparameter import kernels
from photon_tpu_torch.hyperparameter.tuner import (
    HyperparameterTuningMode,
    search,
)

KERNEL_TOL = 1e-12
PREDICT_TOL = 1e-9


# ---------------------------------------------------------------------------
# tests/test_hyperparameter.py on the port
# ---------------------------------------------------------------------------


class TestKernels:
    def test_gram_matches_direct_computation(self, rng):
        x = rng.normal(size=(7, 3))
        amp, noise = 1.7, 1e-3
        ls = np.array([0.8, 1.2, 1.9])
        theta = kernels.make_theta(amp, noise, ls)
        xs = x / ls
        d2 = ((xs[:, None, :] - xs[None, :, :]) ** 2).sum(-1)
        for name, f in [
            ("rbf", lambda d: np.exp(-0.5 * d)),
            ("matern52", lambda d: (1 + np.sqrt(5 * d) + 5 * d / 3)
             * np.exp(-np.sqrt(5 * d))),
        ]:
            k = kernels.gram(name, theta, x).numpy()
            expect = amp * f(d2) + noise * np.eye(7)
            np.testing.assert_allclose(k, expect, rtol=1e-6, atol=1e-9)

    def test_gram_padding_is_identity(self, rng):
        x = np.zeros((8, 2))
        x[:5] = rng.normal(size=(5, 2))
        valid = np.array([1.0] * 5 + [0.0] * 3)
        theta = kernels.make_theta(2.0, 1e-4, np.ones(2))
        k = kernels.gram("matern52", theta, x, valid).numpy()
        np.testing.assert_allclose(k[5:, 5:], np.eye(3))
        np.testing.assert_allclose(k[:5, 5:], 0.0)
        k_small = kernels.gram("matern52", theta, x[:5]).numpy()
        np.testing.assert_allclose(k[:5, :5], k_small, rtol=1e-7)

    def test_log_likelihood_padding_invariant(self, rng):
        """Padded likelihood == unpadded likelihood (the mask algebra)."""
        x = rng.normal(size=(6, 2))
        y = rng.normal(size=6)
        theta = kernels.make_theta(1.3, 1e-2, np.array([0.9, 1.4]))
        lik = float(kernels.log_likelihood("matern52", theta, x, y,
                                           np.ones(6)))
        x_pad = np.zeros((10, 2))
        x_pad[:6] = x
        y_pad = np.zeros(10)
        y_pad[:6] = y
        valid = np.array([1.0] * 6 + [0.0] * 4)
        lik_pad = float(kernels.log_likelihood("matern52", theta, x_pad,
                                               y_pad, valid))
        assert lik == pytest.approx(lik_pad, rel=1e-8)

    def test_log_likelihood_bounds(self, rng):
        x = rng.normal(size=(5, 2))
        y = rng.normal(size=5)
        v = np.ones(5)
        bad = [
            kernels.make_theta(-1.0, 1e-4, np.ones(2)),   # negative amp
            kernels.make_theta(1.0, -1e-4, np.ones(2)),   # negative noise
            kernels.make_theta(1.0, 1e-4, np.array([1.0, -0.5])),
            kernels.make_theta(1.0, 1e-4, np.array([1.0, 2.5])),  # > tophat
        ]
        for theta in bad:
            assert float(kernels.log_likelihood(
                "matern52", theta, x, y, v)) == -np.inf
        ok = kernels.make_theta(1.0, 1e-4, np.ones(2))
        assert np.isfinite(float(kernels.log_likelihood(
            "matern52", ok, x, y, v)))

    def test_higher_likelihood_for_generating_length_scale(self, rng):
        """The marginal likelihood must prefer hyperparameters close to the
        generating process over wildly wrong ones."""
        n = 24
        x = rng.uniform(size=(n, 1))
        y = np.sin(x[:, 0] * 6.0)
        v = np.ones(n)
        good = kernels.make_theta(1.0, 1e-3, np.array([0.3]))
        tiny = kernels.make_theta(1.0, 1e-3, np.array([1e-3]))
        lik_good = float(kernels.log_likelihood("rbf", good, x, y, v))
        lik_tiny = float(kernels.log_likelihood("rbf", tiny, x, y, v))
        assert lik_good > lik_tiny


class TestSliceSampler:
    def test_samples_standard_normal(self):
        """Slice-sampled draws from a known log-density must reproduce its
        moments (the SliceSamplerTest discipline)."""
        def logp(x):
            return -0.5 * float(x @ x)

        s = SliceSampler(rng=np.random.default_rng(7))
        x = np.zeros(1)
        draws = []
        for _ in range(600):
            x = s.draw(x, logp)
            draws.append(x[0])
        draws = np.asarray(draws[100:])
        assert abs(draws.mean()) < 0.2
        assert abs(draws.std() - 1.0) < 0.2

    def test_dimension_wise_covers_all_axes(self):
        def logp(x):
            return -0.5 * float(((x - np.array([2.0, -3.0])) ** 2).sum())

        s = SliceSampler(rng=np.random.default_rng(3))
        x = np.zeros(2)
        for _ in range(300):
            x = s.draw_dimension_wise(x, logp)
        assert abs(x[0] - 2.0) < 2.5
        assert abs(x[1] + 3.0) < 2.5


class TestCriteria:
    def test_expected_improvement_formula(self):
        from scipy.stats import norm

        means = np.array([0.5, -0.2, 1.5])
        variances = np.array([0.25, 1.0, 0.01])
        best = 0.1
        ei = ExpectedImprovement(best)(means, variances).numpy()
        std = np.sqrt(variances)
        gamma = -(means - best) / std
        expect = std * (gamma * norm.cdf(gamma) + norm.pdf(gamma))
        np.testing.assert_allclose(ei, expect, rtol=1e-5, atol=1e-8)
        assert ei.min() >= 0.0

    def test_confidence_bound(self):
        cb = ConfidenceBound(2.0)(np.array([1.0, 2.0]),
                                  np.array([4.0, 0.0])).numpy()
        np.testing.assert_allclose(cb, [1.0 - 4.0, 2.0], rtol=1e-6)
        assert not ConfidenceBound().is_max_opt
        assert ExpectedImprovement(0.0).is_max_opt


class TestRescaling:
    def test_transform_round_trip(self):
        v = np.array([100.0, 16.0, 0.5])
        tmap = {0: "LOG", 1: "SQRT"}
        fwd = transform_forward(v, tmap)
        np.testing.assert_allclose(fwd, [2.0, 4.0, 0.5])
        np.testing.assert_allclose(transform_backward(fwd, tmap), v)

    def test_scale_round_trip_with_discrete(self):
        ranges = [DoubleRange(-2.0, 6.0), DoubleRange(0.0, 4.0)]
        v = np.array([2.0, 3.0])
        fwd = scale_forward(v, ranges, {1})
        np.testing.assert_allclose(fwd, [0.5, 0.6])  # discrete widens by 1
        np.testing.assert_allclose(scale_backward(fwd, ranges, {1}), v)

    def test_unknown_transform_raises(self):
        with pytest.raises(ValueError):
            transform_forward(np.ones(1), {0: "EXP"})


class TestGaussianProcess:
    def test_gp_interpolates_smooth_function(self, rng):
        """GP posterior mean must track a smooth target near the training
        points and report near-zero variance there (GPML 2.1 sanity)."""
        x = np.linspace(0.0, 1.0, 12)[:, None]
        y = np.sin(3.0 * x[:, 0])
        model = GaussianProcessEstimator(kernel="matern52", seed=5).fit(x, y)
        mean, var = model.predict(x)
        np.testing.assert_allclose(mean, y, atol=0.15)
        assert var.max() < 0.5
        # Held-out midpoints interpolate.
        xq = (x[:-1] + x[1:]) / 2.0
        mq, _ = model.predict(xq)
        np.testing.assert_allclose(mq, np.sin(3.0 * xq[:, 0]), atol=0.25)

    def test_gp_variance_grows_off_data(self, rng):
        x = rng.uniform(0.2, 0.4, size=(10, 1))
        y = np.cos(4.0 * x[:, 0])
        model = GaussianProcessEstimator(seed=2).fit(x, y)
        _, var_near = model.predict(np.array([[0.3]]))
        _, var_far = model.predict(np.array([[3.0]]))
        assert var_far[0] > var_near[0]

    def test_normalize_labels_shifts_mean_back(self, rng):
        x = rng.uniform(size=(9, 2))
        y = 50.0 + rng.normal(scale=0.1, size=9)
        model = GaussianProcessEstimator(
            normalize_labels=True, seed=3).fit(x, y)
        mean, _ = model.predict(x)
        assert abs(mean.mean() - 50.0) < 1.0


class _QuadraticEvalFn:
    """Minimal EvaluationFunction: value = (x - target)^2 summed; the
    "model" is just the candidate vector."""

    def __init__(self, target):
        self.target = np.asarray(target)
        self.calls = []

    def __call__(self, candidate):
        value = float(((candidate - self.target) ** 2).sum())
        self.calls.append(np.array(candidate))
        return value, ("model", np.array(candidate), value)

    def convert_observations(self, results):
        return [(vec, value) for _, vec, value in results]


class TestSearch:
    def test_random_search_deterministic_for_seed(self):
        fn1, fn2 = _QuadraticEvalFn([0.3, 0.7]), _QuadraticEvalFn([0.3, 0.7])
        r1 = RandomSearch(2, fn1, seed=11).find(5)
        r2 = RandomSearch(2, fn2, seed=11).find(5)
        for (_, v1, _), (_, v2, _) in zip(r1, r2):
            np.testing.assert_array_equal(v1, v2)
        # Different seed -> different draws.
        r3 = RandomSearch(2, _QuadraticEvalFn([0.3, 0.7]), seed=12).find(5)
        assert any(not np.array_equal(a[1], b[1]) for a, b in zip(r1, r3))

    def test_random_search_candidates_in_unit_cube(self):
        fn = _QuadraticEvalFn([0.5, 0.5, 0.5])
        RandomSearch(3, fn, seed=1).find(8)
        pts = np.stack(fn.calls)
        assert pts.shape == (8, 3)
        assert (pts >= 0.0).all() and (pts <= 1.0).all()

    def test_discrete_params_snap_to_grid(self):
        fn = _QuadraticEvalFn([0.5, 0.5])
        RandomSearch(2, fn, discrete_params={0: 4}, seed=2).find(6)
        pts = np.stack(fn.calls)
        np.testing.assert_allclose(pts[:, 0] * 4, np.round(pts[:, 0] * 4))

    def test_gp_search_beats_random_on_quadratic(self):
        """The GP-guided search must concentrate evaluations near the optimum
        better than blind Sobol draws (GaussianProcessSearchTest)."""
        target = np.array([0.62, 0.31])
        n = 12
        fn_gp = _QuadraticEvalFn(target)
        gp = GaussianProcessSearch(2, fn_gp, seed=4, candidate_pool_size=100)
        gp_results = gp.find(n)
        rand_results = RandomSearch(2, _QuadraticEvalFn(target),
                                    seed=4).find(n)
        best_gp = min(v for _, _, v in gp_results)
        best_rand = min(v for _, _, v in rand_results)
        # GP should be at least as good; allow small slack for MC noise.
        assert best_gp <= best_rand + 0.01
        assert gp.last_model is not None

    def test_find_with_priors_requires_observation(self):
        fn = _QuadraticEvalFn([0.5])
        with pytest.raises(ValueError):
            RandomSearch(1, fn).find_with_priors(3, [], [])

    def test_tuner_mode_dispatch(self):
        fn = _QuadraticEvalFn([0.5])
        assert search(3, 1, "NONE", fn, []) == []
        obs = [(np.array([0.2]), 0.09)]
        out = search(3, 1, HyperparameterTuningMode.RANDOM, fn, obs, seed=9)
        assert len(out) == 3
        out = search(2, 1, "bayesian", fn, obs, seed=9)
        assert len(out) == 2


def _game_setup(rng, reg_type="L2", alpha=None):
    """The reference test's linear GAME problem on the port: 400 x 8
    dense rows in float64 on the CPU, a ``global`` fixed effect, RMSE."""
    from photon_tpu_torch import optim
    from photon_tpu_torch.algorithm.problems import (
        GLMOptimizationConfiguration,
    )
    from photon_tpu_torch.data.dataset import DenseFeatures
    from photon_tpu_torch.data.game_data import make_game_dataset
    from photon_tpu_torch.estimators.game_estimator import (
        FixedEffectCoordinateConfiguration,
        GameEstimator,
    )
    from photon_tpu_torch.hyperparameter import (
        GameEstimatorEvaluationFunction,
    )
    from photon_tpu_torch.types import TaskType

    n, d = 400, 8
    w = rng.normal(size=d)

    def make(seed):
        r = np.random.default_rng(seed)
        x = r.normal(size=(n, d))
        y = x @ w + 0.5 * r.normal(size=n)
        return make_game_dataset(y, {"features": DenseFeatures(x)},
                                 dtype=torch.float64, device="cpu")

    reg = optim.RegularizationContext(optim.RegularizationType(reg_type),
                                      alpha=alpha)
    base = {"global": GLMOptimizationConfiguration(
        regularization=reg, regularization_weight=1.0)}
    est = GameEstimator(
        TaskType.LINEAR_REGRESSION,
        {"global": FixedEffectCoordinateConfiguration("features",
                                                      base["global"])},
        evaluators=["RMSE"], device="cpu")
    fn = GameEstimatorEvaluationFunction(est, base, make(1), make(2),
                                         is_opt_max=False)
    return est, base, fn


class TestGameEvaluationFunction:
    """GameEstimatorEvaluationFunction adapter + tuning-beats-grid e2e."""

    _setup = staticmethod(_game_setup)

    def test_config_vector_round_trip(self, rng):
        _, base, fn = self._setup(rng)
        assert fn.num_params == 1
        vec = fn.configuration_to_vector(base)
        np.testing.assert_allclose(vec, [0.0])  # log(1.0)
        cfg = fn.vector_to_configuration(np.array([math.log(0.05)]))
        assert cfg["global"].regularization_weight == pytest.approx(0.05)

    def test_elastic_net_packs_two_dims(self, rng):
        _, base, fn = self._setup(rng, "ELASTIC_NET", alpha=0.5)
        assert fn.num_params == 2
        vec = fn.configuration_to_vector(base)
        np.testing.assert_allclose(vec, [0.0, 0.5])
        cfg = fn.vector_to_configuration(np.array([math.log(2.0), 0.25]))
        assert cfg["global"].regularization_weight == pytest.approx(2.0)
        assert cfg["global"].regularization.alpha == pytest.approx(0.25)

    def test_evaluation_sign_convention(self, rng):
        """Search minimizes; RMSE (lower-better) passes through unflipped
        and observations round-trip through convert_observations."""
        _, base, fn = self._setup(rng)
        value, result = fn(np.array([0.5]))
        assert value == result.evaluation.primary_evaluation
        obs = fn.convert_observations([result])
        assert len(obs) == 1
        np.testing.assert_allclose(
            obs[0][0],
            scale_forward(fn.configuration_to_vector(result.config),
                          fn.ranges))
        assert obs[0][1] == pytest.approx(value)

    def test_tuning_beats_coarse_grid(self, rng):
        """A GP tuning loop must find a better lambda than a deliberately
        bad grid on a synthetic task."""
        est, base, fn = self._setup(rng)
        # A terrible grid: massive over-regularization.
        grid = [{"global": base["global"].with_regularization_weight(lam)}
                for lam in (1e4, 3e3)]
        grid_results = est.fit(fn.data, fn.validation_data, grid)
        grid_best = min(r.evaluation.primary_evaluation
                        for r in grid_results)
        observations = fn.convert_observations(grid_results)
        tuned = search(6, fn.num_params, "BAYESIAN", fn, observations,
                       seed=3)
        tuned_best = min(r.evaluation.primary_evaluation for r in tuned)
        assert tuned_best < grid_best


class TestLikelihoodParity:
    def test_np_and_torch_likelihoods_agree(self, rng):
        """The sampler's numpy likelihood must equal the torch one."""
        x = rng.normal(size=(9, 2))
        y = rng.normal(size=9)
        for name in ("matern52", "rbf"):
            for theta in (
                kernels.make_theta(1.3, 1e-2, np.array([0.9, 1.4])),
                kernels.make_theta(0.4, 1e-4, np.array([1.8, 0.2])),
            ):
                lik_t = float(kernels.log_likelihood(name, theta, x, y,
                                                     np.ones(9)))
                lik_n = kernels.log_likelihood_np(name, theta.numpy(), x, y)
                assert lik_t == pytest.approx(lik_n, rel=1e-8)
        # Out-of-bounds parity.
        bad = kernels.make_theta(-1.0, 1e-4, np.ones(2))
        assert kernels.log_likelihood_np("rbf", bad.numpy(), x, y) == -np.inf


class TestReviewRegressions:
    def test_zero_lambda_config_vectorizes(self, rng):
        """A grid config trained with lambda=0 must not crash log-space
        packing (CLI default when 'weights' is omitted)."""
        _, base, fn = _game_setup(rng)
        cfg = {"global": base["global"].with_regularization_weight(0.0)}
        assert np.isfinite(fn.configuration_to_vector(cfg)).all()

    def test_zero_range_start_rejected(self, rng):
        import dataclasses as dc

        from photon_tpu_torch.hyperparameter import (
            GameEstimatorEvaluationFunction,
        )

        est, base, fn = _game_setup(rng)
        bad = {"global": dc.replace(base["global"],
                                    regularization_weight_range=(0.0, 10.0))}
        with pytest.raises(ValueError, match="start above 0"):
            GameEstimatorEvaluationFunction(
                est, bad, fn.data, fn.validation_data, is_opt_max=False)

    def test_box_constrained_solve_still_runs(self, rng):
        """A box-constrained fixed-effect solve runs and ends inside the
        box, clamped at it."""
        from photon_tpu_torch import optim
        from photon_tpu_torch.algorithm.problems import (
            GLMOptimizationConfiguration,
            GLMOptimizationProblem,
        )
        from photon_tpu_torch.data.dataset import DenseFeatures, GLMBatch
        from photon_tpu_torch.types import TaskType

        n, d = 50, 3
        x = rng.normal(size=(n, d))
        y = x @ np.array([2.0, -2.0, 0.5]) + 0.01 * rng.normal(size=n)
        batch = GLMBatch(DenseFeatures(torch.from_numpy(x)),
                         torch.from_numpy(y), torch.zeros(n,
                                                          dtype=torch.float64),
                         torch.ones(n, dtype=torch.float64))
        lo, hi = torch.full((d,), -1.0, dtype=torch.float64), torch.full(
            (d,), 1.0, dtype=torch.float64)
        prob = GLMOptimizationProblem(
            task=TaskType.LINEAR_REGRESSION,
            config=GLMOptimizationConfiguration(
                optimizer=optim.OptimizerConfig.lbfgs(
                    box_constraints=(lo, hi))))
        w = prob.run(batch).model.coefficients.means.numpy()
        assert (w >= -1.0 - 1e-9).all() and (w <= 1.0 + 1e-9).all()
        assert w[0] == pytest.approx(1.0, abs=1e-6)  # clamped at the box


class TestSerializationAndShrink:
    CONFIG_JSON = """
    {"tuning_mode": "BAYESIAN",
     "variables": {
        "global.regularizer": {"type": "CONTINUOUS", "min": -4.0,
                               "max": 4.0, "transform": "LOG"},
        "per-user.topK": {"type": "DISCRETE", "min": 1.0, "max": 5.0}
     }}
    """

    def test_config_from_json(self):
        from photon_tpu_torch.hyperparameter import config_from_json

        cfg = config_from_json(self.CONFIG_JSON)
        assert cfg.tuning_mode == HyperparameterTuningMode.BAYESIAN
        assert cfg.names == ["global.regularizer", "per-user.topK"]
        assert cfg.ranges[0].start == -4.0 and cfg.ranges[0].end == 4.0
        assert cfg.discrete_params == {1: 5}  # 5 discrete values in [1, 5]
        assert cfg.transform_map == {0: "LOG"}

    def test_prior_round_trip_and_rescale(self):
        from photon_tpu_torch.hyperparameter import (
            config_from_json,
            prior_from_json,
            rescale_prior_observations,
        )

        cfg = config_from_json(self.CONFIG_JSON)
        prior = json.dumps({"records": [
            {"global.regularizer": "100.0", "per-user.topK": "3",
             "evaluationValue": "0.25"},
            {"evaluationValue": "0.5"},  # falls back to defaults
        ]})
        obs = prior_from_json(
            prior, {"global.regularizer": "1.0", "per-user.topK": "1"},
            cfg.names)
        assert len(obs) == 2
        np.testing.assert_allclose(obs[0][0], [100.0, 3.0])
        assert obs[0][1] == 0.25
        np.testing.assert_allclose(obs[1][0], [1.0, 1.0])
        scaled = rescale_prior_observations(obs, cfg)
        # log10(100) = 2 -> (2 - (-4)) / 8 = 0.75; topK 3 -> (3-1)/(4+1)=0.4.
        np.testing.assert_allclose(scaled[0][0], [0.75, 0.4])

    def test_shrink_bounds_around_prior_optimum(self):
        """getBounds must box in the region the GP thinks is best, clamped
        to the configured ranges (ShrinkSearchRange.scala:147)."""
        from photon_tpu_torch.hyperparameter import (
            config_from_json,
            get_bounds,
        )

        lower, upper = get_bounds(config_from_json(SHRINK_CONFIG),
                                  SHRINK_PRIORS, {}, radius=0.15, seed=2)
        assert 0.0 <= lower[0] < 7.0 < upper[0] <= 10.0
        # The box is ~2*radius of the unit cube = ~3 wide in [0, 10].
        assert (upper[0] - lower[0]) <= 4.0


SHRINK_CONFIG = """
{"tuning_mode": "BAYESIAN",
 "variables": {"lambda": {"type": "CONTINUOUS", "min": 0.0, "max": 10.0}}}
"""
# Prior observations with a clear minimum near lambda = 7.
SHRINK_PRIORS = json.dumps({"records": [
    {"lambda": str(v), "evaluationValue": str((v - 7.0) ** 2)}
    for v in [0.0, 2.0, 4.0, 6.0, 7.0, 8.0, 10.0]]})


# ---------------------------------------------------------------------------
# each module against its reference twin
# ---------------------------------------------------------------------------


def _close(got, want, tol):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


THETAS = [(1.7, 1e-3, [0.8, 1.2, 1.9]), (0.4, 1e-4, [1.8]),
          (2.5, 0.3, [0.2, 0.5, 1.1])]


@pytest.mark.parametrize("name", ["matern52", "rbf"])
@pytest.mark.parametrize("case", range(len(THETAS)))
def test_kernels_match_the_reference(name, case):
    """gram (padded and not), cross and log_likelihood on the same
    inputs, one theta and a batch of three thetas: within 1e-12."""
    from photon_tpu.hyperparameter import kernels as jk

    rng = np.random.default_rng(100 + case)
    amp, noise, ls = THETAS[case]
    x = rng.normal(size=(9, 3))
    xq = rng.normal(size=(5, 3))
    y = rng.normal(size=9)
    valid = np.r_[np.ones(7), np.zeros(2)]
    theta = np.r_[amp, noise, ls]
    _close(kernels.gram(name, theta, x), jk.gram(name, theta, x),
           KERNEL_TOL)
    _close(kernels.gram(name, theta, x, valid),
           jk.gram(name, theta, x, valid), KERNEL_TOL)
    _close(kernels.cross(name, theta, x, xq), jk.cross(name, theta, x, xq),
           KERNEL_TOL)
    _close(kernels.cross(name, theta, xq, x, valid),
           jk.cross(name, theta, xq, x, valid), KERNEL_TOL)
    want = float(jk.log_likelihood(name, theta, x, y, valid))
    got = float(kernels.log_likelihood(name, theta, x, y, valid))
    assert got == pytest.approx(want, rel=KERNEL_TOL, abs=KERNEL_TOL)
    # A batch of thetas gives each one's value.
    batch = np.stack([theta, theta * 1.1, np.r_[theta[:2] * 0.5,
                                                theta[2:]]])
    liks = kernels.log_likelihood(name, batch, x, y, valid).numpy()
    for t, lik in zip(batch, liks):
        assert lik == pytest.approx(
            float(jk.log_likelihood(name, t, x, y, valid)),
            rel=KERNEL_TOL, abs=KERNEL_TOL)


def test_out_of_bounds_and_non_pd_likelihoods_match_the_reference():
    """Every bounds failure, and a K that is not positive definite, give
    -inf in both packages."""
    from photon_tpu.hyperparameter import kernels as jk

    rng = np.random.default_rng(7)
    x = rng.normal(size=(5, 2))
    x[1] = x[0]  # two equal rows: K is singular without noise
    y = rng.normal(size=5)
    v = np.ones(5)
    for theta in ([-1.0, 1e-4, 1, 1], [1.0, -1e-4, 1, 1],
                  [1.0, 1e-4, 1, -0.5], [1.0, 1e-4, 1, 2.5],
                  [1.0, 0.0, 1, 1]):
        theta = np.asarray(theta, float)
        want = float(jk.log_likelihood("matern52", theta, x, y, v))
        got = float(kernels.log_likelihood("matern52", theta, x, y, v))
        assert got == want or abs(got - want) <= KERNEL_TOL * abs(want), (
            theta, got, want)


def test_initial_theta_matches_the_reference():
    from photon_tpu.hyperparameter import kernels as jk

    y = np.random.default_rng(3).normal(size=11)
    _close(kernels.initial_theta(y, 3), jk.initial_theta(y, 3), 1e-15)
    _close(kernels.initial_theta(np.zeros(4), 2),
           jk.initial_theta(np.zeros(4), 2), 0.0)


def test_criteria_match_the_reference():
    from photon_tpu.hyperparameter import criteria as jc

    rng = np.random.default_rng(11)
    means = rng.normal(size=(4, 50))
    variances = rng.uniform(1e-6, 2.0, size=(4, 50))
    for best in (-0.7, 0.0, 1.3):
        _close(ExpectedImprovement(best)(means, variances),
               jc.ExpectedImprovement(best)(means, variances), KERNEL_TOL)
    for k in (0.5, 2.0):
        _close(ConfidenceBound(k)(means, variances),
               jc.ConfidenceBound(k)(means, variances), KERNEL_TOL)


@pytest.mark.parametrize("kernel,noisy,normalize", [
    ("matern52", False, False), ("matern52", True, True),
    ("rbf", False, True)])
def test_gp_predictions_match_the_reference(kernel, noisy, normalize):
    """The same observations and seed: the posterior samples within
    1e-9 and ``predict`` / ``predict_transformed`` within 1e-9."""
    from photon_tpu.hyperparameter import criteria as jc
    from photon_tpu.hyperparameter import gp as jgp

    rng = np.random.default_rng(5)
    x = rng.uniform(size=(11, 2))
    y = np.sin(3.0 * x[:, 0]) + 0.5 * x[:, 1] ** 2 + 0.01 * rng.normal(
        size=11)
    xq = rng.uniform(-0.2, 1.2, size=(40, 2))
    kw = dict(kernel=kernel, noisy_target=noisy, normalize_labels=normalize,
              num_burn_in_samples=30, seed=9)
    want = jgp.GaussianProcessEstimator(**kw).fit(x, y)
    got = GaussianProcessEstimator(**kw).fit(x, y)
    _close(got.thetas, want.thetas, PREDICT_TOL)
    for a, b in zip(got.predict(xq), want.predict(xq)):
        _close(a, b, PREDICT_TOL)
    _close(got.predict_transformed(xq, ExpectedImprovement(-0.3)),
           want.predict_transformed(xq, jc.ExpectedImprovement(-0.3)),
           PREDICT_TOL)


def _quadratic_search(cls, seed, n=8, **kw):
    fn = _QuadraticEvalFn([0.62, 0.31])
    cls(2, fn, seed=seed, **kw).find(n)
    return np.stack(fn.calls)


@pytest.mark.parametrize("seed", [0, 4, 11])
def test_random_search_draws_the_reference_candidates(seed):
    """RandomSearch on the quadratic: the same candidates, bit for bit,
    with and without a discrete dimension."""
    js = importlib.import_module("photon_tpu.hyperparameter.search")
    ps = importlib.import_module("photon_tpu_torch.hyperparameter.search")

    np.testing.assert_array_equal(
        _quadratic_search(ps.RandomSearch, seed),
        _quadratic_search(js.RandomSearch, seed))
    np.testing.assert_array_equal(
        _quadratic_search(ps.RandomSearch, seed,
                          discrete_params={1: 5}),
        _quadratic_search(js.RandomSearch, seed,
                          discrete_params={1: 5}))


@pytest.mark.parametrize("seed", [3, 4])
def test_gp_search_draws_the_reference_candidates(seed):
    """GaussianProcessSearch on the quadratic from the same seed: the
    same candidates within 1e-9 (the first ones are Sobol draws, the
    rest Sobol points chosen by EI), and the last GP's predictions."""
    js = importlib.import_module("photon_tpu.hyperparameter.search")
    ps = importlib.import_module("photon_tpu_torch.hyperparameter.search")

    got_fn, want_fn = (_QuadraticEvalFn([0.62, 0.31]) for _ in range(2))
    got = ps.GaussianProcessSearch(2, got_fn, seed=seed,
                                   candidate_pool_size=100)
    want = js.GaussianProcessSearch(2, want_fn, seed=seed,
                                    candidate_pool_size=100)
    got.find(7)
    want.find(7)
    _close(np.stack(got_fn.calls), np.stack(want_fn.calls), PREDICT_TOL)
    xq = np.random.default_rng(seed).uniform(size=(20, 2))
    for a, b in zip(got.last_model.predict(xq), want.last_model.predict(xq)):
        _close(a, b, PREDICT_TOL)


def test_tuner_with_observations_matches_the_reference():
    """``search`` seeded with the grid's observations, RANDOM and
    BAYESIAN: the same candidates."""
    from photon_tpu.hyperparameter.tuner import search as jsearch

    obs = [(np.array([0.2, 0.9]), 0.6), (np.array([0.7, 0.1]), 0.1)]
    for mode, tol in (("RANDOM", 0.0), ("BAYESIAN", PREDICT_TOL)):
        got_fn, want_fn = (_QuadraticEvalFn([0.62, 0.31]) for _ in range(2))
        search(4, 2, mode, got_fn, obs, seed=5)
        jsearch(4, 2, mode, want_fn, obs, seed=5)
        _close(np.stack(got_fn.calls), np.stack(want_fn.calls), tol)


def test_shrink_bounds_match_the_reference():
    from photon_tpu.hyperparameter import config_from_json as jconfig
    from photon_tpu.hyperparameter import get_bounds as jbounds

    from photon_tpu_torch.hyperparameter import (
        config_from_json,
        get_bounds,
    )

    got = get_bounds(config_from_json(SHRINK_CONFIG), SHRINK_PRIORS, {},
                     radius=0.15, seed=2)
    want = jbounds(jconfig(SHRINK_CONFIG), SHRINK_PRIORS, {}, radius=0.15,
                   seed=2)
    for a, b in zip(got, want):
        _close(a, b, PREDICT_TOL)


@pytest.mark.parametrize("reg_type,alpha", [("L2", None),
                                            ("ELASTIC_NET", 0.5)])
def test_evaluation_function_maps_like_the_reference(rng, reg_type, alpha):
    """The adapter's ranges and its vector <-> configuration maps on the
    same coordinate configuration."""
    from photon_tpu import optim as jax_optim
    from photon_tpu.algorithm.problems import (
        GLMOptimizationConfiguration as JaxConfig,
    )
    from photon_tpu.hyperparameter import (
        GameEstimatorEvaluationFunction as JaxFn,
    )

    _, base, fn = _game_setup(rng, reg_type, alpha)
    jbase = {"global": JaxConfig(
        regularization=jax_optim.RegularizationContext(
            jax_optim.RegularizationType(reg_type), alpha=alpha),
        regularization_weight=1.0)}
    jfn = JaxFn(None, jbase, None, None, is_opt_max=False)
    assert [(r.start, r.end) for r in fn.ranges] == [
        (r.start, r.end) for r in jfn.ranges]
    for point in (np.full(fn.num_params, 0.25), np.full(fn.num_params, 0.8)):
        vec = scale_backward(point, fn.ranges)
        got = fn.vector_to_configuration(vec)["global"]
        want = jfn.vector_to_configuration(vec)["global"]
        assert got.regularization_weight == want.regularization_weight
        assert got.regularization.alpha == want.regularization.alpha
        np.testing.assert_array_equal(
            fn.configuration_to_vector({"global": got}),
            jfn.configuration_to_vector({"global": want}))
